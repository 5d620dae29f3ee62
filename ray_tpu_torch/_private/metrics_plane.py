"""Cluster metrics plane: harvest fan-out, merge math, history, watchdog.

reference parity: _private/metrics_agent.py + dashboard/modules/metrics/
(the reference runs an OpenCensus agent per node and lets an external
Prometheus pull-aggregate, Monarch-style). Here the GCS itself is the
aggregation point so a cluster is observable with zero external infra:

  - **harvest**: `metrics_collect` fans out GCS → node managers → each
    node's workers in one RPC hop (plus pubsub-subscribed drivers),
    mirroring the flight recorder's spans_collect; every process ships
    its `util.metrics.collect_wire()` snapshot tagged with
    node_id/proc/pid and deduped by proc uid.
  - **merge**: ClusterAggregator folds per-process series into cluster
    series with counter-reset detection — a restarted worker (new proc
    uid starting at 0) or an in-place reset folds the vanished
    contribution into a retained base, so merged counters never go
    backwards and rates never go negative.
  - **history**: a bounded in-memory ring of merged samples on the GCS
    (`metrics_history`) powers `ray_tpu top` and dashboard sparklines
    without an external Prometheus.
  - **watchdog**: an always-on evaluator over the harvested series runs
    invariant probes (lease-slot balance, store occupancy vs pinned
    bytes, wait-graph edge age, drop-counter growth, executor queue
    depth, harvest coverage) and emits HEALTH_ALERT cluster events
    naming the offending series and process.

Recording stays pull-based: hot paths pay nothing for this plane beyond
the metrics they already increment; all aggregation cost sits on the
GCS sampler thread at `Config.metrics_sample_interval_s` cadence.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple
from ray_tpu_torch.util.locks import TracedLock

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------
# Per-process snapshot + samplers
# ---------------------------------------------------------------------

# name -> callable run (best-effort) right before this process snapshots
# its registry: components export point-in-time gauges (lease slots,
# store occupancy, wait-graph size) here instead of instrumenting their
# hot paths. Keyed by component name so a re-init replaces, not stacks.
_SAMPLERS: Dict[str, Callable[[], None]] = {}
_SAMPLERS_LOCK = threading.Lock()


def register_sampler(name: str, fn: Callable[[], None]) -> None:
    with _SAMPLERS_LOCK:
        _SAMPLERS[name] = fn


def unregister_sampler(name: str) -> None:
    with _SAMPLERS_LOCK:
        _SAMPLERS.pop(name, None)


# key -> provider returning a JSON-able value attached to this process's
# harvest snapshot under that key. Non-metric payloads that must ride
# the SAME round as the gauges they are judged against (the memory
# plane's leak-probe digests) register here; keyed so a re-init
# replaces. Providers must be small — this ships every harvest.
_SNAPSHOT_EXTRAS: Dict[str, Callable[[], Any]] = {}


def register_snapshot_extra(key: str, fn: Callable[[], Any]) -> None:
    with _SAMPLERS_LOCK:
        _SNAPSHOT_EXTRAS[key] = fn


def unregister_snapshot_extra(key: str) -> None:
    with _SAMPLERS_LOCK:
        _SNAPSHOT_EXTRAS.pop(key, None)


def snapshot_process() -> Dict[str, Any]:
    """This process's full registry in wire format, identity-tagged for
    the harvest (proc uid for dedupe, label/node/pid for exposition)."""
    from ray_tpu_torch._private import spans as spans_lib
    from ray_tpu_torch.util import metrics as metrics_mod
    with _SAMPLERS_LOCK:
        samplers = list(_SAMPLERS.values())
        extras = list(_SNAPSHOT_EXTRAS.items())
    for fn in samplers:
        try:
            fn()
        except Exception:  # noqa: BLE001 - a dead component's sampler
            pass           # must not break the whole snapshot
    snap = {
        "proc_uid": spans_lib.PROC_UID,
        "pid": os.getpid(),
        "proc": spans_lib.process_label(),
        "node_id": spans_lib.process_node_id(),
        "wall_time": time.time(),
        "metrics": metrics_mod.collect_wire(),
    }
    for key, fn in extras:
        try:
            snap[key] = fn()
        except Exception:  # noqa: BLE001 - one broken provider must not
            pass           # blank the whole snapshot
    return snap


# ---------------------------------------------------------------------
# Cross-process merge math
# ---------------------------------------------------------------------


def _series_key(name: str, tags: Dict[str, str]) -> str:
    if not tags:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
    return f"{name}{{{inner}}}"


def merge_histograms(entries: List[Dict[str, Any]]
                     ) -> Optional[Dict[str, Any]]:
    """Merge same-tag histogram contributions from several processes:
    per-bucket counts sum elementwise when boundaries agree; differing
    boundary sets merge onto their sorted union, each source bucket's
    count landing in the union bucket whose upper edge equals the
    source bucket's upper edge. Cumulative counts are exact at every
    edge shared by ALL sources — in particular everywhere in the
    normal case of one binary, one boundary config — and at +Inf. At
    an edge some source lacks, that source's mass sits at its own
    next-higher edge (its overflow mass at +Inf), so the merged
    cumulative there is a LOWER bound and quantile estimates over
    heterogeneous configs bias conservatively HIGH, never low. Each
    entry: {"boundaries": [...], "buckets": [...], "sum": s,
    "count": n}."""
    if not entries:
        return None
    union: List[float] = sorted({b for e in entries
                                 for b in e["boundaries"]})
    buckets = [0] * (len(union) + 1)
    total_sum = 0.0
    total_count = 0
    for e in entries:
        idx = {b: union.index(b) for b in e["boundaries"]}
        for i, count in enumerate(e["buckets"]):
            if i < len(e["boundaries"]):
                buckets[idx[e["boundaries"][i]]] += count
            else:
                buckets[-1] += count  # overflow (+Inf) bucket
        total_sum += e["sum"]
        total_count += e["count"]
    return {"boundaries": union, "buckets": buckets,
            "sum": total_sum, "count": total_count}


class ClusterAggregator:
    """Stateful merge of successive harvests into cluster series.

    Counter-reset handling: each proc's last-seen contribution is
    remembered per series. When a series vanishes from a harvest —
    its whole proc gone (worker died / unreachable), or just that
    series gone from a still-reporting proc (util.metrics.clear()
    removes series outright rather than zeroing them) — its last
    value folds into a retained base, so the merged cumulative total
    holds steady instead of dropping. The fold is decided reversible
    PER SERIES on reappearance: back at >= its folded value means the
    counter actually continued (a transient blip) and the fold
    reverses to avoid double-counting; back below it means a real
    reset and the base stays. A counter that goes BACKWARDS under an
    unchanged proc uid without vanishing (in-place reset) folds its
    previous value the same way. Gauges are point-in-time: summed
    over live procs only, no retention."""

    # Harvest rounds a proc uid may stay absent before its fold
    # records become permanent and are dropped. A dead worker's
    # restart arrives under a NEW uid, so its records can never
    # unfold — without eviction the always-on GCS would grow one
    # record per series per worker EVER started. A uid that does
    # return later than this is treated as a fresh proc: its counts
    # stack on the retained base (a one-time overcount by the folded
    # amount, never a drop — monotonicity holds either way).
    FOLD_EVICT_ROUNDS = 30

    def __init__(self) -> None:
        # (uid, series_key) -> last counter value seen from that proc
        self._last: Dict[Tuple[str, str], float] = {}
        # series_key -> folded-in base from vanished/reset contributions
        self._retained: Dict[str, float] = {}
        # (uid, series_key) -> value folded when the series vanished
        # (blip vs reset is decided if/when it reappears)
        self._series_folded: Dict[Tuple[str, str], float] = {}
        # uid -> consecutive rounds absent from the harvest (fold
        # eviction clock; reset the round the uid reappears)
        self._uid_absent_rounds: Dict[str, int] = {}

    def update(self, snaps: List[Dict[str, Any]]) -> Dict[str, float]:
        """Ingest one harvest; returns the merged flat series map
        {series_key: value}. Histograms contribute `<name>_sum` and
        `<name>_count` series (cumulative, retained like counters)."""
        live: Dict[Tuple[str, str], float] = {}
        gauges: Dict[str, float] = {}
        uids = set()
        for snap in snaps:
            uid = snap["proc_uid"]
            uids.add(uid)
            for m in snap.get("metrics", ()):
                for s in m["series"]:
                    key = _series_key(m["name"], s["tags"])
                    if m["kind"] == "gauge":
                        gauges[key] = gauges.get(key, 0.0) + s["value"]
                    elif m["kind"] == "histogram":
                        for suffix, v in (("_sum", s["sum"]),
                                          ("_count", float(s["count"]))):
                            k2 = _series_key(m["name"] + suffix,
                                             s["tags"])
                            live[(uid, k2)] = \
                                live.get((uid, k2), 0.0) + v
                    else:
                        live[(uid, key)] = \
                            live.get((uid, key), 0.0) + s["value"]
        # vanished series — proc gone from the harvest OR the series
        # gone from a live proc's snapshot — fold into the retained
        # base so the merged total holds instead of dropping
        for (uid, key) in list(self._last):
            if (uid, key) not in live:
                v = self._last.pop((uid, key))
                self._retained[key] = self._retained.get(key, 0.0) + v
                self._series_folded[(uid, key)] = \
                    self._series_folded.get((uid, key), 0.0) + v
        # in-place resets: value regressed under the same uid
        out: Dict[str, float] = {}
        for (uid, key), v in live.items():
            folded = self._series_folded.pop((uid, key), None)
            if folded is not None and v >= folded:
                # the counter continued past its folded value — a
                # transient blip, not a reset: unfold it
                self._retained[key] = \
                    self._retained.get(key, 0.0) - folded
            prev = self._last.get((uid, key))
            if prev is not None and v < prev:
                self._retained[key] = self._retained.get(key, 0.0) + prev
            self._last[(uid, key)] = v
            out[key] = out.get(key, 0.0) + v
        # age out fold records of long-gone procs so the always-on GCS
        # stays bounded under worker churn (their values remain in
        # _retained — only the per-uid unfold bookkeeping is dropped)
        folded_uids = {uid for (uid, _k) in self._series_folded}
        for uid in list(self._uid_absent_rounds):
            if uid in uids or uid not in folded_uids:
                del self._uid_absent_rounds[uid]
        for uid in folded_uids - uids:
            rounds = self._uid_absent_rounds.get(uid, 0) + 1
            if rounds >= self.FOLD_EVICT_ROUNDS:
                self._uid_absent_rounds.pop(uid, None)
                for fk in [fk for fk in self._series_folded
                           if fk[0] == uid]:
                    del self._series_folded[fk]
            else:
                self._uid_absent_rounds[uid] = rounds
        for key, base in self._retained.items():
            if base:
                out[key] = out.get(key, 0.0) + base
        out.update(gauges)
        return out

    def merged_wire(self, snaps: List[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
        """Cluster-merged wire metrics (tags preserved, procs summed) —
        the JSON payload behind /api/metrics `merged`. Stateless: reset
        retention only applies to the flat series from update()."""
        merged: Dict[Tuple[str, str], Dict[str, Any]] = {}
        hist_parts: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
        for snap in snaps:
            for m in snap.get("metrics", ()):
                for s in m["series"]:
                    gk = (m["name"],
                          _series_key(m["name"], s["tags"]))
                    rec = merged.setdefault(gk, {
                        "name": m["name"], "kind": m["kind"],
                        "description": m.get("description", ""),
                        "tags": s["tags"]})
                    if m["kind"] == "histogram":
                        hist_parts.setdefault(gk, []).append(
                            {"boundaries": m["boundaries"],
                             "buckets": s["buckets"], "sum": s["sum"],
                             "count": s["count"]})
                    else:
                        rec["value"] = rec.get("value", 0.0) + s["value"]
        for gk, parts in hist_parts.items():
            merged[gk].update(merge_histograms(parts))
        return list(merged.values())


# ---------------------------------------------------------------------
# History ring
# ---------------------------------------------------------------------


class SeriesHistory:
    """Bounded ring of (wall_ts, merged flat series) samples."""

    def __init__(self, max_samples: int) -> None:
        self._samples: "deque" = deque(maxlen=max(2, int(max_samples)))
        self._lock = threading.Lock()

    def append(self, ts: float, series: Dict[str, float]) -> None:
        with self._lock:
            self._samples.append((ts, series))

    def query(self, names: Optional[List[str]] = None,
              limit: Optional[int] = None) -> List[Tuple[float, Dict]]:
        with self._lock:
            samples = list(self._samples)
        if limit is not None:
            samples = samples[-limit:]
        if names:
            # prefix match so "ray_tpu_tasks" selects every tagged
            # variant of the family
            samples = [
                (ts, {k: v for k, v in sample.items()
                      if any(k.startswith(n) for n in names)})
                for ts, sample in samples]
        return samples


# ---------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------


class Watchdog:
    """Invariant probes over successive harvests. Each probe returns
    alert dicts {key, message, severity, **fields}; emission is
    cooldown-deduped per (probe, key) so a persistent violation alerts
    once per cooldown window, not once per harvest."""

    # minimum stuck window for the lease probe's backlog variant
    # (leaked slots WITH queued work) — must outlive the owner's NM
    # connection-retry transient, which holds a slot un-parked for up
    # to ~10s of backoff
    LEASE_BACKLOG_FLOOR_S = 15.0

    # minimum requests in a harvest window before the serve SLO probes
    # judge it — a p99 or error-rate over 1-2 requests is noise
    SERVE_MIN_REQUESTS = 5

    def __init__(self, emit: Callable[..., None],
                 cooldown_s: float, wait_edge_age_s: float,
                 store_occupancy_frac: float, queue_depth: int,
                 lock_hold_s: float = 5.0,
                 lock_waiters: int = 1,
                 serve_p99_s: float = 2.0,
                 serve_error_rate: float = 0.1,
                 serve_shed_rate: float = 0.5,
                 elastic_reconfig_s: float = 120.0,
                 gang_heartbeat_stale_s: float = 10.0,
                 jit_recompiles: int = 3,
                 jit_recompile_warmup_s: float = 60.0,
                 host_transfer_bytes: float = float(1 << 20),
                 goodput_floor: float = 0.5,
                 goodput_window_s: float = 120.0) -> None:
        self._emit = emit
        self.cooldown_s = cooldown_s
        self.wait_edge_age_s = wait_edge_age_s
        self.store_occupancy_frac = store_occupancy_frac
        self.queue_depth = queue_depth
        self.lock_hold_s = lock_hold_s
        self.lock_waiters = lock_waiters
        self.serve_p99_s = serve_p99_s
        self.serve_error_rate = serve_error_rate
        self.serve_shed_rate = serve_shed_rate
        self.elastic_reconfig_s = elastic_reconfig_s
        self.gang_heartbeat_stale_s = gang_heartbeat_stale_s
        self.jit_recompiles = jit_recompiles
        self.jit_recompile_warmup_s = jit_recompile_warmup_s
        self.host_transfer_bytes = host_transfer_bytes
        self.goodput_floor = goodput_floor
        self.goodput_window_s = goodput_window_s
        # goodput probe: job -> deque of (monotonic ts, {bucket: total})
        # snapshots spanning the sliding window
        self._goodput_window: Dict[str, "deque"] = {}
        # jax sentinel storm probe: step-region label -> monotonic ts
        # its first compile series appeared (warmup grace clock)
        self._jit_first_seen: Dict[str, float] = {}
        # serve SLO probes: last cumulative per-deployment request
        # histogram / per-(deployment, code) request counts (and shed
        # counts, for the shed-burn probe); the probe judges
        # per-harvest DELTAS so an old breach can't alert forever
        self._prev_serve_hist: Dict[str, Dict[str, Any]] = {}
        self._prev_serve_req: Dict[Tuple[str, str], float] = {}
        self._prev_serve_shed: Dict[str, float] = {}
        self._prev_serve_admitted: Dict[str, float] = {}
        self._last_alert: Dict[Tuple[str, str], float] = {}
        # lease probe: uid -> (leaked-slot count, monotonic ts it was
        # first seen stuck at that value)
        self._lease_stuck: Dict[str, Tuple[float, float]] = {}
        # memory-plane leak probes: (kind, node, oid) -> monotonic ts
        # first seen suspect (a suspect must survive a full harvest
        # interval before alerting — absence races are one-round long)
        self._mem_suspect: Dict[Tuple[str, str, str], float] = {}
        self._prev_series: Dict[str, float] = {}
        self.alerts_total = 0

    # -- helpers ------------------------------------------------------

    @staticmethod
    def _gauge(snap: Dict[str, Any], name: str) -> Optional[float]:
        for m in snap.get("metrics", ()):
            if m["name"] == name and m["series"]:
                return sum(s["value"] for s in m["series"])
        return None

    def _alert(self, probe: str, key: str, message: str,
               severity: str = "WARNING", **fields: Any) -> None:
        now = time.monotonic()
        last = self._last_alert.get((probe, key))
        if last is not None and now - last < self.cooldown_s:
            return
        self._last_alert[(probe, key)] = now
        # expired records no longer dedupe anything — drop them, or the
        # always-on GCS accrues one per (probe, proc-uid) ever alerted
        if len(self._last_alert) > 256:
            self._last_alert = {
                k: t for k, t in self._last_alert.items()
                if now - t < self.cooldown_s}
        self.alerts_total += 1
        logger.warning("watchdog %s: %s", probe, message)
        self._emit("HEALTH_ALERT", message, severity=severity,
                   probe=probe, series=key, **fields)

    # -- probes -------------------------------------------------------

    def _probe_lease_slots(self, snaps: List[Dict[str, Any]],
                           interval_s: float) -> None:
        """A proc holding lease request slots that are not parked at an
        NM awaiting a grant has leaked them — after
        MAX_PENDING_LEASE_REQUESTS leaks that key never schedules again
        (core_worker ~1203). Alerted in two variants: with an EMPTY
        queue after two harvest intervals (unambiguous — nothing is
        driving the slots), and with QUEUED work after a longer floor
        (the stalled-with-backlog case, worse for the user but
        transiently indistinguishable from an actively-placing
        request). A slot PARKED at a saturated NM with a drained queue
        is a legitimate steady state (the granted lease absorbed every
        queued task) and never alarms, however long the NM stays full.
        Stuck windows are wall-time, not round counts, so back-to-back
        forced harvests can't fake persistence."""
        window = 2.0 * max(interval_s, 0.05)
        # With queued work, in_flight > parked is ALSO the normal shape
        # of an actively-placing request (slot claimed, "queued" reply
        # pending) and of the NM connection-retry loop, which holds a
        # slot un-parked for up to ~10s (core_worker conn_failures x
        # 0.2s backoff) — so the backlog variant needs a floor long
        # enough to outlive both. It matters MORE than the empty-queue
        # one: leaked slots with tasks queued is a key starving user
        # work (once MAX_PENDING_LEASE_REQUESTS slots leak it never
        # requests again), and any churn — a grant, a park, a new
        # request — changes `leaked` and restarts the clock, so only a
        # genuinely frozen key rides out the floor.
        backlog_window = max(window, self.LEASE_BACKLOG_FLOOR_S)
        now = time.monotonic()
        seen = set()
        for snap in snaps:
            uid = snap["proc_uid"]
            in_flight = self._gauge(snap,
                                    "ray_tpu_lease_requests_in_flight")
            queued = self._gauge(snap, "ray_tpu_lease_queued_tasks")
            if in_flight is None or queued is None:
                continue
            parked = self._gauge(
                snap, "ray_tpu_lease_requests_parked") or 0.0
            seen.add(uid)
            leaked = in_flight - parked
            if leaked <= 0:
                self._lease_stuck.pop(uid, None)
                continue
            prev, since = self._lease_stuck.get(uid, (None, now))
            if prev != leaked:
                since = now
            self._lease_stuck[uid] = (leaked, since)
            if now - since < (window if queued == 0 else backlog_window):
                continue
            if queued == 0:
                msg = (f"{snap['proc']}: {leaked:g} lease request "
                       f"slot(s) held {now - since:.1f}s with no "
                       f"queued tasks and no request parked at a "
                       f"node manager — leaked requests_in_flight "
                       f"stalls that scheduling key permanently")
            else:
                msg = (f"{snap['proc']}: {leaked:g} lease request "
                       f"slot(s) held {now - since:.1f}s not parked "
                       f"at any node manager while {queued:g} task(s) "
                       f"sit queued — leaked slots are starving "
                       f"queued work of lease requests")
            self._alert("lease_slot_balance", uid, msg,
                        severity="ERROR", proc=snap["proc"],
                        node_id=snap.get("node_id"), value=leaked)
        for uid in list(self._lease_stuck):
            if uid not in seen:
                del self._lease_stuck[uid]

    def _probe_store_occupancy(self, snaps: List[Dict[str, Any]]) -> None:
        for snap in snaps:
            used = self._gauge(snap, "ray_tpu_object_store_used_bytes")
            cap = self._gauge(snap,
                              "ray_tpu_object_store_capacity_bytes")
            pinned = self._gauge(snap,
                                 "ray_tpu_object_store_pinned_bytes")
            if used is None or not cap:
                continue
            node = snap.get("node_id")
            if pinned is not None and pinned > used:
                self._alert(
                    "store_pin_accounting", snap["proc_uid"],
                    f"node {str(node)[:12]}: pinned bytes "
                    f"({pinned:g}) exceed used bytes ({used:g}) — "
                    f"pin/lease accounting leak", severity="ERROR",
                    node_id=node, value=pinned)
            elif used / cap > self.store_occupancy_frac:
                self._alert(
                    "store_occupancy", snap["proc_uid"],
                    f"node {str(node)[:12]}: object store "
                    f"{100.0 * used / cap:.0f}% full "
                    f"({used:g}/{cap:g} bytes; pinned {pinned or 0:g})",
                    node_id=node, value=used)

    def _probe_wait_edge_age(self, snaps: List[Dict[str, Any]]) -> None:
        for snap in snaps:
            age = self._gauge(snap,
                              "ray_tpu_wait_graph_max_edge_age_seconds")
            if age is not None and age > self.wait_edge_age_s:
                self._alert(
                    "wait_edge_age", "gcs",
                    f"oldest actor wait edge is {age:.0f}s old "
                    f"(> {self.wait_edge_age_s:g}s) — a blocking get "
                    f"may be stuck short of a detectable cycle",
                    value=age)

    # Task-event drops only: losing task events loses real cluster
    # state. ray_tpu_spans_dropped_total is deliberately NOT here —
    # the span ring is drop-oldest BY DESIGN (always-on recording
    # wraps in steady state), so its growth is normal operation and
    # alerting on it would train operators to ignore HEALTH_ALERTs.
    _DROP_COUNTERS = ("ray_tpu_task_events_dropped_total",)

    def _probe_drop_growth(self, series: Dict[str, float]) -> None:
        for name in self._DROP_COUNTERS:
            cur = series.get(name)
            prev = self._prev_series.get(name)
            if cur is not None and prev is not None and cur > prev:
                self._alert(
                    "drop_growth", name,
                    f"{name} grew by {cur - prev:g} since the last "
                    f"harvest (total {cur:g}) — telemetry is being "
                    f"shed under load", value=cur)

    def _probe_queue_depth(self, snaps: List[Dict[str, Any]]) -> None:
        for snap in snaps:
            depth = self._gauge(snap, "ray_tpu_executor_queue_depth")
            if depth is not None and depth > self.queue_depth:
                self._alert(
                    "executor_queue_depth", snap["proc_uid"],
                    f"{snap['proc']}: executor queue depth {depth:g} "
                    f"exceeds {self.queue_depth} — replica/actor is "
                    f"saturated and calls are piling up",
                    proc=snap["proc"], node_id=snap.get("node_id"),
                    value=depth)

    def _probe_memory(self, snaps: List[Dict[str, Any]],
                      interval_s: float,
                      unreachable: List[str]) -> None:
        """Memory-plane leak probes over the harvest's digests
        (memory_plane.py: each core worker ships what it claims holds
        objects alive; each node manager ships its store's held-alive
        entries). Three invariants:

          - every PINNED store object is claimed by a live owner
            (violation: the owner died without releasing — the classic
            leak `ray_tpu memory` exists for);
          - every store reader LEASE is accounted by a live process's
            replica-lease table (violation: a leased view leaked, the
            block can never be evicted);
          - an object the owner already FREED is not still store-
            resident (violation: refcount vs residency mismatch).

        A suspect must persist a full harvest interval before alerting
        (creation/free races are one-round long), so a real leak alerts
        within two harvest intervals. Absence of a claim is only
        evidence when coverage was complete, so skipped rounds —
        unreachable nodes, truncated/capped digests, or a node whose
        harvest carried fewer worker digests than its node manager has
        registered workers (one stalled worker must not read as a dead
        owner) — also RESET the suspect clocks rather than letting
        them age through unverified rounds."""
        from ray_tpu_torch._private import memory_plane as memory_plane_lib
        if unreachable:
            self._mem_suspect.clear()
            return
        claimed: set = set()
        freed: set = set()
        # reader-lease claims are per NODE: a proc's replica leases are
        # held on its OWN node's store, and a cluster-wide sum would
        # let a legitimate lease on node B mask a leaked one on node A
        leases_claimed: Dict[Tuple[str, str], int] = {}
        workers_digested: Dict[str, int] = {}
        digests = 0
        for snap in snaps:
            mem = snap.get(memory_plane_lib.PROC_DIGEST_KEY)
            if not mem:
                continue
            digests += 1
            if mem.get("dropped"):
                # capped digest: absence proves nothing this round, and
                # suspect clocks must not age through it
                self._mem_suspect.clear()
                return
            node = str(snap.get("node_id") or "?")
            if mem.get("kind") == "worker":
                workers_digested[node] = workers_digested.get(node, 0) + 1
            claimed.update(mem.get("owned_store") or ())
            freed.update(mem.get("freed") or ())
            for oid, n in (mem.get("leases") or {}).items():
                leases_claimed[(node, oid)] = \
                    leases_claimed.get((node, oid), 0) + n
        if not digests:
            return
        window = max(interval_s, 0.05)
        now = time.monotonic()
        seen: set = set()

        def suspect(kind: str, node: str, oid: str) -> bool:
            """True once the suspect has persisted a full interval."""
            key = (kind, node, oid)
            seen.add(key)
            first = self._mem_suspect.setdefault(key, now)
            return now - first >= window

        for snap in snaps:
            store = snap.get(memory_plane_lib.STORE_DIGEST_KEY)
            if not store or store.get("truncated"):
                continue
            node = str(snap.get("node_id") or "?")
            expected = store.get("registered_workers")
            if expected is not None and \
                    workers_digested.get(node, 0) < expected:
                # a registered worker on this node missed the harvest
                # (slow GIL-bound pull, spawn race): its claims are
                # unknown, so absence-based checks would false-alarm —
                # skip the node and restart its suspect clocks
                for key in [k for k in self._mem_suspect
                            if k[1] == node]:
                    del self._mem_suspect[key]
                continue
            for oid, size, pinned, leases, _spilled, age_s in \
                    store.get("entries") or ():
                young = age_s is not None and age_s < window
                if oid in freed and not young:
                    if suspect("freed_resident", node, oid):
                        self._alert(
                            "store_residency_mismatch", f"{node}:{oid}",
                            f"node {node[:12]}: object {oid[:16]} "
                            f"({size or 0} bytes) is still store-"
                            f"resident after its owner freed it — "
                            f"refcount vs residency mismatch",
                            severity="ERROR", node_id=node,
                            object_id=oid, value=float(size or 0))
                    continue
                if (pinned or 0) > 0 and oid not in claimed \
                        and not young:
                    if suspect("dead_owner", node, oid):
                        self._alert(
                            "store_leak_dead_owner", f"{node}:{oid}",
                            f"node {node[:12]}: object {oid[:16]} "
                            f"({size or 0} bytes) is pinned in the "
                            f"store but no live owner claims it — "
                            f"likely leaked by a dead owner; it will "
                            f"never be freed",
                            severity="ERROR", node_id=node,
                            object_id=oid, value=float(size or 0))
                node_claims = leases_claimed.get((node, oid), 0)
                if (leases or 0) > node_claims and not young:
                    if suspect("orphan_lease", node, oid):
                        self._alert(
                            "store_orphaned_lease", f"{node}:{oid}",
                            f"node {node[:12]}: object {oid[:16]} "
                            f"holds {leases} reader lease(s) but live "
                            f"processes on that node account for "
                            f"{node_claims} — leaked leases make the "
                            f"block unevictable",
                            node_id=node, object_id=oid,
                            value=float(leases or 0))
        # forget suspects that resolved (freed, claimed, or released)
        for key in list(self._mem_suspect):
            if key not in seen:
                del self._mem_suspect[key]

    def _probe_locks(self, snaps: List[Dict[str, Any]]) -> None:
        """Lockdep probes over the traced-lock digests riding the
        harvest (util/locks.py digest()): per-process, (1) a cycle in
        the observed acquisition-order graph — two code paths took the
        same locks in opposite orders, a deadlock that merely hasn't
        fired yet (the order is the bug, lockdep semantics); (2) a
        lock held past the configured threshold while threads queue
        behind it — a stalled critical section starving the process.
        Edges accumulate for the process's lifetime, so an inversion
        alerts within the next harvest interval and the cooldown
        dedupes the repeats."""
        from ray_tpu_torch.util import locks as locks_lib
        for snap in snaps:
            d = snap.get(locks_lib.DIGEST_KEY)
            if not d:
                continue
            # the digest pre-computes the cycle over its process's FULL
            # edge graph (the shipped edge list is capped); fall back
            # to detecting over the shipped edges for older digests
            cycle = d.get("cycle") or locks_lib.find_cycle(
                (a, b) for a, b in d.get("edges", ()))
            if cycle:
                path = " -> ".join(cycle)
                self._alert(
                    "lock_order_inversion",
                    f"{snap['proc_uid']}:{path}",
                    f"{snap['proc']}: observed lock acquisition orders "
                    f"form a cycle {path} — threads interleaving these "
                    f"paths deadlock; pick one global order (static "
                    f"twin: graftlint RT016)", severity="ERROR",
                    proc=snap["proc"], node_id=snap.get("node_id"))
            for lh in d.get("long_holds", ()):
                if lh.get("held_s", 0.0) >= self.lock_hold_s and \
                        lh.get("waiters", 0) >= self.lock_waiters:
                    self._alert(
                        "lock_long_hold",
                        f"{snap['proc_uid']}:{lh['name']}",
                        f"{snap['proc']}: lock {lh['name']!r} held "
                        f"{lh['held_s']:.1f}s (> {self.lock_hold_s:g}s) "
                        f"with {lh['waiters']} thread(s) queued — a "
                        f"stalled critical section is starving this "
                        f"process", proc=snap["proc"],
                        node_id=snap.get("node_id"),
                        value=lh["held_s"])

    def _probe_serve_slo(self, snaps: List[Dict[str, Any]]) -> None:
        """Serve SLO probes over the harvested RED metrics (serve/
        _telemetry.py): per deployment and per harvest window,

          - ``serve_latency_slo``: the p99 upper bound from this
            round's request-histogram DELTA (cumulative buckets diffed
            against the previous round, merged across processes) over
            `serve_p99_s`;
          - ``serve_error_burn``: the 5xx fraction of this round's
            request-count delta over `serve_error_rate` (4xx are the
            client's errors and don't burn the budget).

        Windows with fewer than SERVE_MIN_REQUESTS requests are
        skipped, as are rounds whose deltas go negative (proxy/handle
        churn reset a counter — judging them would fabricate traffic).
        A sustained breach alerts within two harvest intervals (one
        round to baseline, one to judge) and the cooldown dedupes the
        repeats."""
        hist_parts: Dict[str, List[Dict[str, Any]]] = {}
        req: Dict[Tuple[str, str], float] = {}
        for snap in snaps:
            for m in snap.get("metrics", ()):
                if m["name"] == "ray_tpu_serve_request_seconds" \
                        and m["kind"] == "histogram":
                    for s in m["series"]:
                        dep = s["tags"].get("deployment", "?")
                        hist_parts.setdefault(dep, []).append(
                            {"boundaries": m["boundaries"],
                             "buckets": s["buckets"],
                             "sum": s["sum"], "count": s["count"]})
                elif m["name"] == "ray_tpu_serve_requests_total":
                    for s in m["series"]:
                        key = (s["tags"].get("deployment", "?"),
                               s["tags"].get("code", "?"))
                        req[key] = req.get(key, 0.0) + s["value"]
        # prune deployments gone from the harvest — the always-on GCS
        # must stay bounded under deployment churn (a returning
        # deployment just pays one fresh baseline round)
        for dep in [d for d in self._prev_serve_hist
                    if d not in hist_parts]:
            del self._prev_serve_hist[dep]
        # latency SLO from histogram deltas
        for dep, parts in hist_parts.items():
            cur = merge_histograms(parts)
            prev = self._prev_serve_hist.get(dep)
            self._prev_serve_hist[dep] = cur
            if prev is None or prev["boundaries"] != cur["boundaries"]:
                continue
            delta = [c - p for c, p in zip(cur["buckets"],
                                           prev["buckets"])]
            total = cur["count"] - prev["count"]
            if total < self.SERVE_MIN_REQUESTS or \
                    any(d < 0 for d in delta):
                continue
            target = 0.99 * total
            cum = 0
            p99_edge: Optional[float] = None  # None = overflow bucket
            for bound, d in zip(cur["boundaries"], delta):
                cum += d
                if cum >= target:
                    p99_edge = bound
                    break
            top = cur["boundaries"][-1]
            if p99_edge is not None and p99_edge <= self.serve_p99_s:
                continue
            shown = p99_edge if p99_edge is not None else top
            self._alert(
                "serve_latency_slo", dep,
                f"deployment {dep!r}: p99 request latency "
                f"{'>' if p99_edge is None else '<='} {shown:g}s over "
                f"the last harvest window ({total:g} requests) exceeds "
                f"the {self.serve_p99_s:g}s SLO",
                deployment=dep, value=float(shown))
        # error burn from request-count deltas. Deltas are judged
        # per KEY against the previous round; a key absent from prev —
        # first appearance, or a vanish/reappear across an unreachable
        # round — is BASELINED, not judged, exactly like the histogram
        # probe (else a reappearing counter's full cumulative history
        # reads as one window and fires a false ERROR from old traffic)
        deltas: Dict[str, Dict[str, float]] = {}
        ok = True
        for key, v in req.items():
            prev_v = self._prev_serve_req.get(key)
            if prev_v is None:
                continue  # baseline round for this key
            d = v - prev_v
            if d < 0:
                ok = False  # counter churn: skip the whole round
                break
            dep, code = key
            # 503 = admission shed (Retry-After contract): an overload
            # signal with its own probe (serve_shed_burn), not an error
            # burning the availability budget — excluded from BOTH
            # numerator and denominator (errors judged against
            # ADMITTED traffic; a brownout must not dilute a real 5xx
            # burn happening underneath it). The only 503 source in
            # this stack is the ingress admission plane.
            if code == "503":
                continue
            rec = deltas.setdefault(dep, {"total": 0.0, "errors": 0.0})
            rec["total"] += d
            if code.startswith("5"):
                rec["errors"] += d
        self._prev_serve_req = req
        if not ok:
            return
        for dep, rec in deltas.items():
            if rec["total"] < self.SERVE_MIN_REQUESTS:
                continue
            rate = rec["errors"] / rec["total"]
            if rate > self.serve_error_rate:
                self._alert(
                    "serve_error_burn", dep,
                    f"deployment {dep!r}: {rec['errors']:g} of "
                    f"{rec['total']:g} requests ({100 * rate:.0f}%) "
                    f"failed with 5xx over the last harvest window "
                    f"(error-rate SLO {100 * self.serve_error_rate:.0f}"
                    f"%)", severity="ERROR", deployment=dep,
                    value=rate)

    def _probe_serve_shed(self, snaps: List[Dict[str, Any]]) -> None:
        """``serve_shed_burn``: sustained load shedding at the ingress
        fleet. Judges per-harvest DELTAS of
        ``ray_tpu_serve_shed_total`` against the same window's total
        offered load (admitted ``requests_total`` + shed): a shed
        fraction above `serve_shed_rate` means clients are being
        browned out faster than the Retry-After contract can absorb —
        scale the deployment (or raise its admission limits) before
        goodput collapses. First-appearance keys baseline like the
        other serve probes; windows under SERVE_MIN_REQUESTS offered
        requests are noise and skipped."""
        shed: Dict[str, float] = {}
        admitted: Dict[str, float] = {}
        for snap in snaps:
            for m in snap.get("metrics", ()):
                if m["name"] == "ray_tpu_serve_shed_total":
                    for s in m["series"]:
                        dep = s["tags"].get("deployment", "?")
                        shed[dep] = shed.get(dep, 0.0) + s["value"]
                elif m["name"] == "ray_tpu_serve_requests_total":
                    for s in m["series"]:
                        dep = s["tags"].get("deployment", "?")
                        admitted[dep] = admitted.get(dep, 0.0) \
                            + s["value"]
        prev_shed, self._prev_serve_shed = self._prev_serve_shed, shed
        prev_req = self._prev_serve_admitted
        self._prev_serve_admitted = dict(admitted)
        for dep, shed_now in shed.items():
            shed_before = prev_shed.get(dep)
            if shed_before is None:
                continue  # baseline round for this deployment
            d_shed = shed_now - shed_before
            d_req = admitted.get(dep, 0.0) - prev_req.get(dep, 0.0)
            if d_shed < 0 or d_req < 0:
                continue  # proxy churn reset a counter: re-baseline
            # requests_total ALREADY includes sheds (they respond 503
            # at the proxy, where the counter lives) — offered load is
            # d_req itself; the max() only guards a legacy proxy that
            # sheds without counting
            offered = max(d_req, d_shed)
            if offered < self.SERVE_MIN_REQUESTS or d_shed <= 0:
                continue
            rate = d_shed / offered
            if rate > self.serve_shed_rate:
                self._alert(
                    "serve_shed_burn", dep,
                    f"deployment {dep!r}: ingress shed {d_shed:g} of "
                    f"{offered:g} offered requests ({100 * rate:.0f}%) "
                    f"over the last harvest window (shed-rate SLO "
                    f"{100 * self.serve_shed_rate:.0f}%) — sustained "
                    f"overload; scale the deployment or raise its "
                    f"admission limits", severity="ERROR",
                    deployment=dep, value=rate)

    def _probe_elastic(self, snaps: List[Dict[str, Any]]) -> None:
        """elastic_stuck_reconfig: a gang reconfiguration
        (train/elastic.py ReconfigTracker, riding the harvest as
        `elastic:*` snapshot extras) has been in flight longer than
        elastic_reconfig_s. The age is computed in the snapshot from
        the owner's monotonic clock, so a single observation above the
        threshold is already a sustained stall — no cross-interval
        state needed; the cooldown dedupes repeats."""
        for snap in snaps:
            for key, extra in snap.items():
                if not key.startswith("elastic:") or \
                        not isinstance(extra, dict):
                    continue
                if not extra.get("in_progress"):
                    continue
                age = float(extra.get("age_s", 0.0))
                if age <= self.elastic_reconfig_s:
                    continue
                gang = extra.get("gang", key)
                # dedup on the per-INSTANCE extra key, not the gang
                # name: two same-named gangs in one driver must not
                # share a cooldown (one stuck gang would mute the
                # other's alert)
                self._alert(
                    "elastic_stuck_reconfig",
                    f"{snap.get('proc_uid', '')}:{key}",
                    f"elastic gang {gang!r} on {snap.get('proc', '?')} "
                    f"(pid {snap.get('pid', '?')}) stuck in "
                    f"reconfiguration phase "
                    f"{extra.get('phase', '?')!r} for {age:.0f}s "
                    f"(> {self.elastic_reconfig_s:.0f}s; reason="
                    f"{extra.get('reason', '?')})",
                    severity="ERROR", gang=gang,
                    phase=extra.get("phase"), age_s=age)

    @staticmethod
    def _series_tags(key: str) -> Dict[str, str]:
        """Tags of a flat series key (`name{k=v,...}`). Sentinel labels
        are span/region names (no commas or braces), so plain splitting
        is exact for the series this parser is used on."""
        i = key.find("{")
        if i < 0 or not key.endswith("}"):
            return {}
        out: Dict[str, str] = {}
        for part in key[i + 1:-1].split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                out[k] = v
        return out

    def _probe_gang_wedge(self, series: Dict[str, float]) -> None:
        """`gang_rank_wedged`: a rank's heartbeat age
        (`ray_tpu_gang_heartbeat_age_seconds{gang,rank}`, exported by
        the GCS from its gang heartbeat table each harvest) exceeds
        gang_heartbeat_stale_s. The sidecar beats every ~0.5s even
        while the rank's main thread sits inside a collective, so an
        age this large means the PROCESS is stopped — SIGSTOP'd, hard
        GIL stall, frozen host — not a slow step. The age is an
        absolute value from the GCS monotonic clock (no cross-interval
        delta needed), so the alert lands within the harvest interval
        that first observes the breach; the cooldown dedupes repeats
        while the gang supervisor's step-deadline trip tears the rank
        down. Fed from TWO cadences with identical series keys: the
        harvested gauge here in evaluate(), and the plane's liveness
        tick reading the GCS table directly — the latter because a
        wedged worker stalls the harvest fan-out for the full worker
        snapshot timeout, exactly the window this probe must fire in."""
        for key, v in series.items():
            if not key.startswith(
                    "ray_tpu_gang_heartbeat_age_seconds{"):
                continue
            if v <= self.gang_heartbeat_stale_s:
                continue
            tags = self._series_tags(key)
            gang = tags.get("gang", "?")
            rank = tags.get("rank", "?")
            self._alert(
                "gang_rank_wedged", key,
                f"gang {gang!r} rank {rank}: no heartbeat for "
                f"{v:.1f}s (> {self.gang_heartbeat_stale_s:.0f}s) — "
                f"the rank process is wedged (SIGSTOP, hard stall, or "
                f"frozen host), not merely slow; the gang supervisor's "
                f"step deadline will hard-kill it and re-form the gang "
                f"(reason=wedge)", severity="ERROR",
                gang=gang, rank=rank, value=v)

    def _probe_replay_stall(self, series: Dict[str, float]) -> None:
        """`replay_shard_stall`: a replay shard with un-acked pushes
        outstanding (`ray_tpu_replay_push_inflight{shard}` > 0) whose
        add counter (`ray_tpu_replay_added_total{shard}`) did not move
        since the previous harvest is absorbing pushes without applying
        them — a wedged or overloaded shard actor. Writers keep shedding
        against its full inflight window, so the symptom the trainer
        sees is silent sample loss, not an error. First-appearance
        series baseline (prev None), so a stalled shard alerts within
        two harvest intervals."""
        for key, inflight in series.items():
            if not key.startswith("ray_tpu_replay_push_inflight{"):
                continue
            if inflight <= 0:
                continue
            shard = self._series_tags(key).get("shard", "?")
            added_key = f"ray_tpu_replay_added_total{{shard={shard}}}"
            cur = series.get(added_key)
            prev = self._prev_series.get(added_key)
            if cur is None or prev is None:
                continue  # baseline round for this shard
            if cur <= prev:
                self._alert(
                    "replay_shard_stall", key,
                    f"replay shard {shard}: {inflight:g} pushes in "
                    f"flight but added_total did not move this harvest "
                    f"(stuck at {cur:g}) — the shard actor is wedged "
                    f"or overloaded and writers are shedding against "
                    f"its full window", shard=shard, value=inflight)

    def _probe_jax_sentinel(self, series: Dict[str, float]) -> None:
        """`jit_recompile_storm` / `unexpected_host_transfer`: per-
        harvest deltas of the jax sentinel's counters
        (util/jax_sentinel.py; static twins graftlint RT020/RT021).

          - a step-region label whose kind=recompile compile count
            grows by >= jit_recompiles within one window is recompiling
            in steady state — a shape/static-arg/donation hazard is
            making XLA rebuild the step it should be replaying. Labels
            get a warmup grace (jit_recompile_warmup_s from their first
            compile): a cold start legitimately compiles several
            modules under one label across a couple of windows.
          - host-transfer bytes accounted INSIDE a step region growing
            by >= host_transfer_bytes per window mean the hot step is
            forcing device→host syncs it shouldn't (the sanctioned
            forcing points live outside the regions).

        region="untracked"/fn="untracked" series are never judged —
        outside a step region a transfer or compile is by definition
        not on a hot path. First-appearance series BASELINE (prev round
        None), so a real storm alerts within two harvest intervals."""
        now = time.monotonic()
        fns_seen = set()
        for key in series:
            if key.startswith("ray_tpu_jit_compiles_total{"):
                fn = self._series_tags(key).get("fn")
                if fn:
                    fns_seen.add(fn)
                    self._jit_first_seen.setdefault(fn, now)
        # labels gone from the harvest drop their warmup clocks — the
        # always-on GCS stays bounded under driver churn (a returning
        # label just re-enters warmup grace)
        for fn in [f for f in self._jit_first_seen
                   if f not in fns_seen]:
            del self._jit_first_seen[fn]
        for key, v in series.items():
            prev = self._prev_series.get(key)
            if prev is None:
                continue  # baseline round for this series
            delta = v - prev
            if delta <= 0:
                continue
            if key.startswith("ray_tpu_jit_compiles_total{"):
                tags = self._series_tags(key)
                fn = tags.get("fn", "?")
                if tags.get("kind") != "recompile" \
                        or fn == "untracked":
                    continue
                first = self._jit_first_seen.get(fn, now)
                if now - first < self.jit_recompile_warmup_s \
                        or delta < self.jit_recompiles:
                    continue
                self._alert(
                    "jit_recompile_storm", key,
                    f"step region {fn!r}: {delta:g} XLA recompile(s) "
                    f"within one harvest window (total {v:g}) — the "
                    f"step is recompiling in steady state instead of "
                    f"replaying its cache; look for shape-varying "
                    f"args, python scalars traced as constants, or "
                    f"donation retriggers (static twin: graftlint "
                    f"RT020)", severity="ERROR", fn=fn, value=delta)
            elif key.startswith("ray_tpu_host_transfer_bytes_total{"):
                region = self._series_tags(key).get("region", "?")
                if region == "untracked":
                    continue
                if delta < self.host_transfer_bytes:
                    continue
                self._alert(
                    "unexpected_host_transfer", key,
                    f"step region {region!r}: {delta:g} bytes forced "
                    f"device→host within one harvest window "
                    f"(> {self.host_transfer_bytes:g}) — a hidden "
                    f".item()/np coercion/device_get is syncing the "
                    f"hot step (static twin: graftlint RT021; spans: "
                    f"host_sync.* in `ray_tpu timeline --spans`)",
                    severity="ERROR", region=region, value=delta)

    def _probe_goodput(self, series: Dict[str, float],
                       interval_s: float) -> None:
        """`goodput_regression`: a job's productive_step fraction of
        its accounted wall time over the sliding window
        (goodput_window_s) dropped below goodput_floor — the gang is
        alive but its time is going somewhere other than training.
        Judged from per-window DELTAS of the harvested
        `ray_tpu_goodput_seconds_total{job,bucket}` counters (so an old
        bad patch can't alert forever), and the alert names the
        DOMINANT badput bucket — the triage pointer: feed_stall means
        starve the sampler less, elastic_reconfig/wedge_recovery means
        churn, compile means a recompile hazard (see the
        jit_recompile_storm probe), idle means unattributed driver
        time (graftlint RT024's territory). Windows where the job was
        live for under half the wall time are skipped — a ledger that
        just appeared (or a paused harvest) must not read as badput."""
        now = time.monotonic()
        prefix = "ray_tpu_goodput_seconds_total{"
        totals: Dict[str, Dict[str, float]] = {}
        for key, v in series.items():
            if not key.startswith(prefix):
                continue
            tags = self._series_tags(key)
            job = tags.get("job")
            bucket = tags.get("bucket")
            if job and bucket:
                totals.setdefault(job, {})[bucket] = v
        # evict jobs gone from the harvest (ledger's proc died); a
        # returning job pays one fresh baseline window
        for job in [j for j in self._goodput_window if j not in totals]:
            del self._goodput_window[job]
        window = max(self.goodput_window_s, 0.0)
        for job, cur in totals.items():
            dq = self._goodput_window.setdefault(job, deque())
            dq.append((now, cur))
            # keep one entry at-or-past the window edge as the baseline
            while len(dq) >= 3 and now - dq[1][0] >= window:
                dq.popleft()
            if len(dq) < 2:
                continue  # baseline round for this job
            t0, base = dq[0]
            wall = now - t0
            if wall <= 0:
                continue
            deltas = {b: max(0.0, cur.get(b, 0.0) - base.get(b, 0.0))
                      for b in set(cur) | set(base)}
            accounted = sum(deltas.values())
            if accounted < 0.5 * wall:
                continue  # job not live for most of the window
            productive = deltas.get("productive_step", 0.0)
            frac = productive / accounted
            if frac >= self.goodput_floor:
                continue
            badput = {b: d for b, d in deltas.items()
                      if b != "productive_step" and d > 0}
            dominant, dom_s = max(
                badput.items(), key=lambda kv: kv[1],
                default=("idle", 0.0))
            self._alert(
                "goodput_regression", job,
                f"job {job!r}: productive fraction "
                f"{100.0 * frac:.0f}% over the last {wall:.0f}s is "
                f"below the {100.0 * self.goodput_floor:.0f}% floor — "
                f"dominant badput bucket is {dominant!r} "
                f"({dom_s:.1f}s of {accounted:.1f}s accounted); see "
                f"`ray_tpu goodput --job {job}`", severity="ERROR",
                job=job, value=frac, dominant=dominant)

    def _probe_harvest_coverage(self, unreachable: List[str]) -> None:
        for node in unreachable:
            self._alert(
                "harvest_unreachable", node,
                f"metrics harvest could not reach node "
                f"{node[:12]} — its series are stale this round",
                node_id=node)

    def evaluate(self, snaps: List[Dict[str, Any]],
                 series: Dict[str, float],
                 unreachable_nodes: List[str],
                 interval_s: float = 2.0) -> None:
        for probe in (lambda: self._probe_lease_slots(snaps, interval_s),
                      lambda: self._probe_store_occupancy(snaps),
                      lambda: self._probe_wait_edge_age(snaps),
                      lambda: self._probe_drop_growth(series),
                      lambda: self._probe_queue_depth(snaps),
                      lambda: self._probe_memory(snaps, interval_s,
                                                 unreachable_nodes),
                      lambda: self._probe_locks(snaps),
                      lambda: self._probe_serve_slo(snaps),
                      lambda: self._probe_serve_shed(snaps),
                      lambda: self._probe_elastic(snaps),
                      lambda: self._probe_gang_wedge(series),
                      lambda: self._probe_jax_sentinel(series),
                      lambda: self._probe_replay_stall(series),
                      lambda: self._probe_goodput(series, interval_s),
                      lambda: self._probe_harvest_coverage(
                          unreachable_nodes)):
            try:
                probe()
            except Exception:  # noqa: BLE001 - one broken probe must
                logger.exception("watchdog probe failed")  # not kill the rest
        self._prev_series = series


# ---------------------------------------------------------------------
# GCS-hosted plane
# ---------------------------------------------------------------------


class MetricsPlane:
    """Owns the sampler thread, harvest fan-out, aggregator, history
    ring, and watchdog. Hosted by the GcsServer; its RPC surface is
    registered there (metrics_collect / metrics_prometheus /
    metrics_history / metrics_merged / metrics_configure)."""

    COLLECT_TIMEOUT_S = 5.0

    def __init__(self, gcs: Any,
                 history_dir: Optional[str] = None) -> None:
        from ray_tpu_torch._private.config import Config
        from ray_tpu_torch._private.metrics_history import TieredHistory
        from ray_tpu_torch.util.metrics import (Gauge, Histogram,
                                          get_or_create)
        self._gcs = gcs
        self.interval_s = Config.metrics_sample_interval_s
        self.history = TieredHistory(
            Config.metrics_history_samples,
            dir=Config.metrics_history_dir or history_dir or None,
            retention_bytes=Config.metrics_history_retention_bytes,
            segment_samples=Config.metrics_history_segment_samples)
        self.aggregator = ClusterAggregator()
        self.watchdog = Watchdog(
            emit=gcs._emit,
            cooldown_s=Config.watchdog_cooldown_s,
            wait_edge_age_s=Config.watchdog_wait_edge_age_s,
            store_occupancy_frac=Config.watchdog_store_occupancy_frac,
            queue_depth=Config.watchdog_queue_depth,
            lock_hold_s=Config.watchdog_lock_hold_s,
            lock_waiters=Config.watchdog_lock_waiters,
            serve_p99_s=Config.watchdog_serve_p99_s,
            serve_error_rate=Config.watchdog_serve_error_rate,
            serve_shed_rate=Config.watchdog_serve_shed_rate,
            elastic_reconfig_s=Config.watchdog_elastic_reconfig_s,
            gang_heartbeat_stale_s=Config.watchdog_gang_heartbeat_s,
            jit_recompiles=Config.watchdog_jit_recompiles,
            jit_recompile_warmup_s=(
                Config.watchdog_jit_recompile_warmup_s),
            host_transfer_bytes=Config.watchdog_host_transfer_bytes,
            goodput_floor=Config.watchdog_goodput_floor,
            goodput_window_s=Config.watchdog_goodput_window_s)
        self._harvest_hist = get_or_create(
            Histogram, "ray_tpu_metrics_harvest_seconds",
            description="wall time of one cluster metrics harvest "
                        "(fan-out + merge + watchdog)",
            boundaries=[0.001, 0.005, 0.02, 0.1, 0.5, 2.0])
        self._procs_gauge = get_or_create(
            Gauge, "ray_tpu_metrics_harvest_procs",
            description="processes covered by the last metrics harvest")
        # Runtime step-deadline override for gang supervisors
        # (metrics_configure(step_deadline_s=...)): the GCS hands it
        # back on every gang_heartbeats query, so the wedge deadline is
        # tunable live without touching the trainer. None = defer to
        # ScalingConfig.step_deadline_s / auto-calibration.
        self.step_deadline_override_s: Optional[float] = None
        self._lock = TracedLock("metrics_plane")
        # serializes full rounds: the sampler loop and on-demand callers
        # (scrapes, dumps) never harvest concurrently
        self._round_lock = TracedLock("metrics_round")
        self._last_snaps: List[Dict[str, Any]] = []
        self._last_series: Dict[str, float] = {}
        self._last_harvest_mono = 0.0
        self._last_history_mono = 0.0
        self._wake = threading.Event()
        self._stopped = False
        self._thread = threading.Thread(target=self._sample_loop,
                                        daemon=True, name="gcs-metrics")
        self._thread.start()
        # Liveness tick: the gang-wedge probe on its own short cadence,
        # fed straight from the GCS heartbeat table. It must not ride
        # the harvest — a wedged (SIGSTOP'd) worker stalls the fan-out
        # for the full worker-pull timeout, which is exactly when the
        # probe needs to fire (and the gang supervisor's trip clears
        # the table moments later).
        self._liveness_wake = threading.Event()
        self._liveness_thread = threading.Thread(
            target=self._liveness_loop, daemon=True,
            name="gcs-metrics-liveness")
        self._liveness_thread.start()

    # -- liveness tick ------------------------------------------------

    def _liveness_loop(self) -> None:
        """Evaluate the gang-wedge probe against LIVE heartbeat ages on
        a cadence independent of harvest latency. The harvested-gauge
        path in Watchdog.evaluate still runs (the alert cooldown keys
        are identical, so the two cadences dedupe); this loop exists so
        the alert SLO (<= 2 harvest intervals after staleness) holds
        even while the harvest itself is stalled behind the wedged
        rank's snapshot pull."""
        while not self._stopped:
            period = self.interval_s if self.interval_s > 0 else 1.0
            self._liveness_wake.wait(
                timeout=min(1.0, max(0.25, period)))
            self._liveness_wake.clear()
            if self._stopped:
                return
            try:
                ages = self._gcs.gang_heartbeat_age_series()
                if ages:
                    self.watchdog._probe_gang_wedge(ages)
            except Exception:  # noqa: BLE001 - probe tick must not die
                logger.exception("gang liveness probe tick failed")

    # -- harvest fan-out ----------------------------------------------

    def collect(self) -> List[Dict[str, Any]]:
        """The `metrics_collect` RPC: an explicit harvest-NOW — callers
        asking for this want a guaranteed-fresh gather (tests inducing a
        state then asserting on the snapshot; operators debugging)."""
        return self._run_round(force=True)

    def _harvest(self) -> Tuple[List[Dict[str, Any]], List[str]]:
        """Two-phase gather mirroring gcs.spans_collect: node managers
        first (each ships its own + its workers' snapshots and names the
        worker addresses it covered), then the remaining pubsub
        subscribers — drivers, and workers whose NM dropped out."""
        from ray_tpu_torch._private import spans as spans_lib
        own = snapshot_process()
        nm_replies, cw_replies, unreachable = \
            spans_lib.gather_cluster_snapshots(
                self._gcs, "nm_metrics_snapshot", "cw_metrics_snapshot",
                timeout=self.COLLECT_TIMEOUT_S)
        gathered: List[Dict[str, Any]] = []
        for _addr, reply, _t0, _t1 in nm_replies:
            gathered.extend(reply["snapshots"])
        gathered.extend(snap for _a, snap, _t0, _t1 in cw_replies)
        return spans_lib.dedupe_by_uid([own] + gathered), unreachable

    def _run_round(self, force: bool = False) -> List[Dict[str, Any]]:
        """One full round — fan-out, aggregate, history sample, watchdog
        — shared by the sampler loop and on-demand callers (/metrics
        scrapes, dumps; with interval 0 the plane runs PURELY on demand,
        and every scrape still advances the aggregator/history/watchdog
        state). A non-forced caller arriving while the last round is
        fresh gets its cached snapshots instead of re-fanning out —
        and never stalls behind an in-progress harvest (which can hold
        _round_lock for the full collect timeout when a node is
        unreachable): if the cache is stale because a slow round is
        mid-flight, the scrape gets the last COMPLETED round rather
        than blocking, so /metrics stays responsive exactly when a
        node outage makes rounds slow."""
        freshness = max(self.interval_s, 1.0)

        def _cached():
            with self._lock:
                age = time.monotonic() - self._last_harvest_mono
                snaps = self._last_snaps
            return snaps if snaps and age < freshness else None

        if not force:
            snaps = _cached()
            if snaps is not None:
                return snaps
            # cache stale AND a round in progress (it holds _round_lock
            # for up to two collect timeouts when a node is down): a
            # scrape must not stall behind the fan-out — serve the last
            # COMPLETED round, however stale, and let the in-progress
            # one refresh the cache for the next caller. Only when no
            # round ever completed (cold start) is waiting the better
            # trade.
            if not self._round_lock.acquire(blocking=False):
                with self._lock:
                    stale = self._last_snaps
                if stale:
                    return stale
                self._round_lock.acquire()
        else:
            self._round_lock.acquire()
        try:
            if not force:
                # a round finished while we waited for the lock
                snaps = _cached()
                if snaps is not None:
                    return snaps
            t0 = time.monotonic()
            snaps, unreachable = self._harvest()
            series = self.aggregator.update(snaps)
            # the ring's retention contract is samples x interval_s of
            # NON-forced samples: rounds forced between sampler ticks
            # (collects, dumps) land in the raw tier tagged forced=True
            # — visible to sparklines (no gaps), excluded from rate
            # computation and from the retention count — instead of
            # being dropped outright as they were pre-PR-20
            due = (self.interval_s <= 0
                   or t0 - self._last_history_mono
                   >= 0.9 * self.interval_s)
            kinds = {m["name"]: m["kind"]
                     for snap in snaps
                     for m in snap.get("metrics", ())}
            self.history.append(time.time(), series, kinds=kinds,
                                forced=not due)
            if due:
                self._last_history_mono = t0
            self.watchdog.evaluate(snaps, series, unreachable,
                                   interval_s=self.interval_s)
            self._procs_gauge.set(float(len(snaps)))
            self._harvest_hist.observe(time.monotonic() - t0)
            with self._lock:
                self._last_snaps = snaps
                self._last_series = series
                self._last_harvest_mono = time.monotonic()
            return snaps
        finally:
            self._round_lock.release()

    # -- sampler loop -------------------------------------------------

    def _sample_loop(self) -> None:
        while not self._stopped:
            interval = self.interval_s
            if interval <= 0:
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                continue
            self._wake.wait(timeout=interval)
            self._wake.clear()
            if self._stopped:
                return
            try:
                self._run_round(force=True)
            except Exception:  # noqa: BLE001
                logger.exception("metrics harvest round failed")

    # -- RPC surface (registered by GcsServer) ------------------------

    def prometheus(self, force: bool = False) -> str:
        """Cluster-merged Prometheus exposition: every harvested series
        labeled by proc + node (histogram buckets cumulative per
        series; HELP/TYPE once per metric name). A scrape serves the
        sampler's last round while it is fresh (< one interval old),
        so an external scraper — however fast — adds no fan-out load
        on top of the sampler cadence; `force=True` (CLI dumps, tests
        inducing a state then asserting on it) harvests NOW."""
        from ray_tpu_torch.util.metrics import render_prometheus
        flat: List[Dict[str, Any]] = []
        for snap in self._run_round(force=force):
            extra = {"proc": snap["proc"]}
            if snap.get("node_id"):
                extra["node"] = str(snap["node_id"])[:12]
            for m in snap["metrics"]:
                flat.append({**m, "extra_tags": extra})
        return render_prometheus(flat)

    def merged(self, fresh: bool = False) -> Dict[str, Any]:
        """One consistent view of the last round: the per-proc
        snapshots, the flat merged series, and the tag-preserving
        merged wire metrics all come from the SAME harvest (served from
        cache while fresh — the dashboard's JSON poll loop does not
        re-fan-out the cluster per request). `fresh=True` harvests NOW,
        matching the text dump's force= semantics."""
        self._run_round(force=fresh)
        # snaps and series are stored together under _lock at the end
        # of every round — reading both under one acquisition keeps the
        # payload's views from straddling two rounds
        with self._lock:
            snaps = self._last_snaps
            series = dict(self._last_series)
        return {"ts": time.time(),
                "interval_s": self.interval_s,
                "procs": snaps,
                "series": series,
                "merged": self.aggregator.merged_wire(snaps)}

    def query_history(self, names: Optional[List[str]] = None,
                      limit: Optional[int] = None) -> Dict[str, Any]:
        rows = self.history.query_ex(names=names, limit=limit)
        return {"interval_s": self.interval_s,
                "samples": [(ts, series) for ts, series, _f in rows],
                "forced": [f for _ts, _s, f in rows]}

    def query_history_range(self, names: Optional[List[str]] = None,
                            since_s: float = 600.0,
                            tier: str = "raw") -> Dict[str, Any]:
        """The `metrics_history_range` RPC: lookback-window read across
        the durable tiers (raw samples, or downsampled windows with
        counters as per-window deltas and gauges as [min, mean, max]),
        reaching through on-disk segments — including pre-restart ones
        replayed at GCS startup."""
        return {"interval_s": self.interval_s,
                "tier": tier,
                "samples": self.history.range_query(
                    names=names, since_s=since_s, tier=tier)}

    def configure(self, interval_s: Optional[float] = None,
                  cooldown_s: Optional[float] = None,
                  wait_edge_age_s: Optional[float] = None,
                  store_occupancy_frac: Optional[float] = None,
                  queue_depth: Optional[int] = None,
                  lock_hold_s: Optional[float] = None,
                  lock_waiters: Optional[int] = None,
                  serve_p99_s: Optional[float] = None,
                  serve_error_rate: Optional[float] = None,
                  serve_shed_rate: Optional[float] = None,
                  elastic_reconfig_s: Optional[float] = None,
                  gang_heartbeat_stale_s: Optional[float] = None,
                  step_deadline_s: Optional[float] = None,
                  jit_recompiles: Optional[int] = None,
                  jit_recompile_warmup_s: Optional[float] = None,
                  host_transfer_bytes: Optional[float] = None,
                  goodput_floor: Optional[float] = None,
                  goodput_window_s: Optional[float] = None
                  ) -> Dict[str, Any]:
        """Runtime tuning (ops + tests): adjust the sample interval and
        watchdog thresholds without restarting the GCS.
        `step_deadline_s` plants the gang supervisors' runtime per-step
        deadline override (<= 0 clears it back to config/auto)."""
        if interval_s is not None:
            self.interval_s = float(interval_s)
            self._wake.set()
        if cooldown_s is not None:
            self.watchdog.cooldown_s = float(cooldown_s)
        if wait_edge_age_s is not None:
            self.watchdog.wait_edge_age_s = float(wait_edge_age_s)
        if store_occupancy_frac is not None:
            self.watchdog.store_occupancy_frac = \
                float(store_occupancy_frac)
        if queue_depth is not None:
            self.watchdog.queue_depth = int(queue_depth)
        if lock_hold_s is not None:
            self.watchdog.lock_hold_s = float(lock_hold_s)
        if lock_waiters is not None:
            self.watchdog.lock_waiters = int(lock_waiters)
        if serve_p99_s is not None:
            self.watchdog.serve_p99_s = float(serve_p99_s)
        if serve_error_rate is not None:
            self.watchdog.serve_error_rate = float(serve_error_rate)
        if serve_shed_rate is not None:
            self.watchdog.serve_shed_rate = float(serve_shed_rate)
        if elastic_reconfig_s is not None:
            self.watchdog.elastic_reconfig_s = float(elastic_reconfig_s)
        if gang_heartbeat_stale_s is not None:
            self.watchdog.gang_heartbeat_stale_s = \
                float(gang_heartbeat_stale_s)
        if step_deadline_s is not None:
            self.step_deadline_override_s = \
                float(step_deadline_s) if step_deadline_s > 0 else None
        if jit_recompiles is not None:
            self.watchdog.jit_recompiles = int(jit_recompiles)
        if jit_recompile_warmup_s is not None:
            self.watchdog.jit_recompile_warmup_s = \
                float(jit_recompile_warmup_s)
        if host_transfer_bytes is not None:
            self.watchdog.host_transfer_bytes = \
                float(host_transfer_bytes)
        if goodput_floor is not None:
            self.watchdog.goodput_floor = float(goodput_floor)
        if goodput_window_s is not None:
            self.watchdog.goodput_window_s = float(goodput_window_s)
        return {"interval_s": self.interval_s,
                "cooldown_s": self.watchdog.cooldown_s,
                "wait_edge_age_s": self.watchdog.wait_edge_age_s,
                "store_occupancy_frac":
                    self.watchdog.store_occupancy_frac,
                "queue_depth": self.watchdog.queue_depth,
                "lock_hold_s": self.watchdog.lock_hold_s,
                "lock_waiters": self.watchdog.lock_waiters,
                "serve_p99_s": self.watchdog.serve_p99_s,
                "serve_error_rate": self.watchdog.serve_error_rate,
                "serve_shed_rate": self.watchdog.serve_shed_rate,
                "elastic_reconfig_s":
                    self.watchdog.elastic_reconfig_s,
                "gang_heartbeat_stale_s":
                    self.watchdog.gang_heartbeat_stale_s,
                "step_deadline_s": self.step_deadline_override_s,
                "jit_recompiles": self.watchdog.jit_recompiles,
                "jit_recompile_warmup_s":
                    self.watchdog.jit_recompile_warmup_s,
                "host_transfer_bytes":
                    self.watchdog.host_transfer_bytes,
                "goodput_floor": self.watchdog.goodput_floor,
                "goodput_window_s": self.watchdog.goodput_window_s}

    def stop(self) -> None:
        self._stopped = True
        self._wake.set()
        self._liveness_wake.set()
        try:
            # flush buffered history segments so a restart replays
            # right up to the last harvest
            self.history.stop()
        except Exception:  # noqa: BLE001 - shutdown is best-effort
            logger.exception("metrics history flush failed on stop")
