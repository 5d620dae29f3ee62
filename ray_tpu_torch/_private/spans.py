"""Flight recorder: always-on, per-process span ring buffer.

Dapper-style sampled-at-the-edge tracing for the intra-process layer the
task-event records (task_events.py, task granularity) can't see: every
hot path records microsecond spans into a fixed-size ring, steady-state
overhead is bounded by the ring (drop-oldest, never blocks), and the GCS
gathers all rings on demand into one cluster-merged Chrome trace
(`ray_tpu timeline --spans`, see gcs.spans_collect + api.timeline).

Design constraints:
  - lock-light: recording is an index bump + slot write (a lost
    increment under a rare write race overwrites one slot; the recorder
    must never contend on the paths it measures)
  - monotonic timestamps (`perf_counter`) — wall clock only appears in
    snapshot metadata, where the merger uses it (plus an RPC-midpoint
    offset estimate) to align processes onto one timebase
  - compile-to-no-op: with RAY_TPU_SPANS=0, span() returns a shared
    no-op context manager and instant() returns immediately — call
    sites pay one flag check
  - drop-oldest with an exported `ray_tpu_spans_dropped_total` counter

Span records are tuples (ph, name, t_mono, dur_s, tid, trace_id, attrs):
ph "X" = complete span, "i" = instant event (Chrome trace phases).
"""

from __future__ import annotations

import os
import threading
import uuid
from _thread import get_ident as _get_ident
from time import perf_counter
from time import time as _wall_time
from typing import Any, Dict, Iterable, List, Optional

# One id per interpreter: snapshots are deduped on it when a process is
# reachable through two fan-out paths (e.g. the head process hosts the
# GCS, a node manager, AND the driver core worker).
PROC_UID = uuid.uuid4().hex

DEFAULT_CAPACITY = 16384

_tls = threading.local()


def _env_enabled() -> bool:
    return os.environ.get("RAY_TPU_SPANS", "1").lower() not in (
        "0", "false", "no", "off")


_enabled = _env_enabled()
_process_label: Optional[str] = None
_node_id: Optional[str] = None


class SpanRing:
    """Fixed-size drop-oldest ring of span records.

    record() is deliberately unlocked: a data race costs one overwritten
    slot, never a corrupt structure (list item assignment is atomic in
    CPython), and the recorder sits on paths whose latency it measures.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(16, int(capacity))
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._i = 0
        self._dropped_synced = 0  # already added to the metric

    def record(self, rec: tuple) -> None:
        i = self._i
        self._i = i + 1
        self._buf[i % self.capacity] = rec

    @property
    def dropped_total(self) -> int:
        return max(0, self._i - self.capacity)

    def snapshot_records(self) -> List[tuple]:
        """Current contents, oldest first (best-effort under concurrent
        writers)."""
        i = self._i
        n = self.capacity
        if i <= n:
            out = self._buf[:i]
        else:
            head = i % n
            out = self._buf[head:] + self._buf[:head]
        return [r for r in out if r is not None]

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._i = 0
        self._dropped_synced = 0

    def sync_dropped_metric(self) -> int:
        """Push the drop count delta into the process metrics registry;
        returns the lifetime total. Called from snapshot(), off the
        recording hot path."""
        total = self.dropped_total
        delta = total - self._dropped_synced
        if delta > 0:
            self._dropped_synced = total
            try:
                from ray_tpu_torch.util.metrics import Counter, get_or_create
                get_or_create(
                    Counter, "ray_tpu_spans_dropped_total",
                    description="flight-recorder spans overwritten by "
                                "ring-buffer drop-oldest").inc(delta)
            except Exception:  # noqa: BLE001 - metrics are best-effort
                pass
        return total


def _ring_capacity() -> int:
    try:
        return int(os.environ.get("RAY_TPU_SPANS_CAPACITY",
                                  DEFAULT_CAPACITY))
    except ValueError:
        return DEFAULT_CAPACITY


_RING = SpanRing(_ring_capacity())


def configure(enabled: Optional[bool] = None,
              capacity: Optional[int] = None) -> None:
    """Runtime switch (tests, the spans-overhead bench). Processes read
    RAY_TPU_SPANS at import, so workers inherit the env var instead."""
    global _enabled, _RING
    if enabled is not None:
        _enabled = bool(enabled)
    if capacity is not None:
        _RING = SpanRing(capacity)


def enabled() -> bool:
    return _enabled


def ring() -> SpanRing:
    return _RING


def set_process_label(label: str, node_id: Optional[str] = None) -> None:
    """Name this process's row in the merged trace (driver-1a2b, a
    worker id, raylet, gcs). Last caller wins — one process, one row."""
    global _process_label, _node_id
    _process_label = label
    if node_id is not None:
        _node_id = node_id


def process_label() -> str:
    """This process's trace-row name (also the metrics plane's `proc`
    label — one identity per process across both planes)."""
    return _process_label or f"proc-{os.getpid()}"


def process_node_id() -> Optional[str]:
    return _node_id


def set_current_trace(trace_id: Optional[str]) -> None:
    """Mirror of the core worker's trace TLS (kept here so recording
    never imports the worker stack)."""
    _tls.trace_id = trace_id


def get_current_trace() -> Optional[str]:
    return getattr(_tls, "trace_id", None)


class _Span:
    __slots__ = ("name", "attrs", "t0", "trace_id")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.trace_id = getattr(_tls, "trace_id", None)
        self.t0 = 0.0

    def __enter__(self) -> Dict[str, Any]:
        self.t0 = perf_counter()
        return self.attrs

    def __exit__(self, exc_type, exc, tb) -> None:
        # lean on purpose: this records on the paths whose latency it
        # measures (ring.record is an index bump + slot write)
        t1 = perf_counter()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        ring = _RING
        i = ring._i
        ring._i = i + 1
        ring._buf[i % ring.capacity] = (
            "X", self.name, self.t0, t1 - self.t0, _get_ident(),
            self.trace_id, self.attrs or None)


class _NoopSpan:
    """Shared no-op: call sites may still write attrs into the dict it
    yields (bounded: keys only, values overwritten)."""

    __slots__ = ("attrs",)

    def __init__(self):
        self.attrs: Dict[str, Any] = {}

    def __enter__(self) -> Dict[str, Any]:
        return self.attrs

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NOOP = _NoopSpan()
# public no-op for call sites that gate a span on their own condition:
#   with (span("x") if big else spans.NOOP): ...
NOOP = _NOOP


def span(name: str, /, **attrs: Any):
    """Context manager recording one complete span; yields its attrs
    dict so values computed mid-span can ride along:

        with span("cw.store_value") as sp:
            ...
            sp["bytes"] = total

    `name` is positional-only so an attr may also be called "name"
    (e.g. task.run spans carry the task's function name).
    """
    if not _enabled:
        return _NOOP
    return _Span(name, attrs)


def start_span(name: str, /, **attrs: Any):
    """Manual begin/end variant for code whose span must bracket a
    region a `with` block can't (e.g. a finally-heavy executor body).
    Returns the span; call `finish_span(sp)` to record it, or None when
    disabled."""
    if not _enabled:
        return None
    sp = _Span(name, attrs)
    sp.__enter__()
    return sp


def finish_span(sp) -> None:
    if sp is not None:
        sp.__exit__(None, None, None)


def begin() -> float:
    """Cheapest span start: just the clock (pair with end()). The
    context-manager protocol costs ~1µs of interpreter overhead per
    span; the always-on spans on the put/get critical path use this
    pair instead so the recorder stays under 1% there."""
    return perf_counter()


def end(name: str, t0: float, /, **attrs: Any) -> None:
    """Record a span begun with begin(); no-op when disabled."""
    if not _enabled:
        return
    t1 = perf_counter()
    ring = _RING
    i = ring._i
    ring._i = i + 1
    ring._buf[i % ring.capacity] = (
        "X", name, t0, t1 - t0, _get_ident(),
        getattr(_tls, "trace_id", None), attrs or None)


def complete(name: str, dur_s: float, /, **attrs: Any) -> None:
    """Record a span that ends NOW with an externally-measured duration
    — for stages whose start lived in another process (serve's replica
    time-in-queue: the handle's submit wall stamp → execution start).
    The record lands on this process's timeline ending at the current
    instant, stretching `dur_s` back — exactly end() with a
    back-computed t0."""
    if not _enabled:
        return
    end(name, perf_counter() - max(0.0, dur_s), **attrs)


def instant(name: str, /, **attrs: Any) -> None:
    """Point-in-time event (Chrome trace ph 'i')."""
    if not _enabled:
        return
    _RING.record(("i", name, perf_counter(), 0.0,
                  _get_ident(), getattr(_tls, "trace_id", None),
                  attrs or None))


# ---------------------------------------------------------------------
# Snapshot + cluster merge
# ---------------------------------------------------------------------


def pull_snapshot(addr, method: str, timeout: float,
                  call_kwargs: Optional[Dict[str, Any]] = None):
    """One snapshot RPC with the wall-clock stamps every collector's
    offset estimate needs (peer_wall - our_wall, from the RPC midpoint
    or entry point — the caller picks the reference). Returns
    (reply, t0_wall, t1_wall) or None when the peer is unreachable —
    dead processes just drop out of the trace. `call_kwargs` rides the
    RPC verbatim (the log plane pushes its filters server-side)."""
    from ray_tpu_torch._private import rpc as rpc_lib
    try:
        client = rpc_lib.RpcClient(tuple(addr), timeout=timeout)
        t0 = _wall_time()
        reply = client.call(method, **(call_kwargs or {}))
        t1 = _wall_time()
        client.close()
    except Exception:  # noqa: BLE001 - peer gone mid-collect
        return None
    return reply, t0, t1


def pull_snapshots(addrs, method: str, timeout: float,
                   grace_s: float = 1.0,
                   call_kwargs: Optional[Dict[str, Any]] = None
                   ) -> List[tuple]:
    """pull_snapshot fanned out to many peers on daemon threads under
    one shared deadline (per-RPC timeout + grace for the joins).
    Returns [(addr, reply, t0_wall, t1_wall)] for the peers that
    answered; unreachable peers just drop out. Every gather point (NM
    worker gathers, GCS span and metrics collects) goes through here so
    the deadline/join semantics can't silently diverge between planes."""
    from time import monotonic
    lock = threading.Lock()
    out: List[tuple] = []

    def _pull(addr) -> None:
        got = pull_snapshot(addr, method, timeout=timeout,
                            call_kwargs=call_kwargs)
        if got is None:
            return
        reply, t0, t1 = got
        with lock:
            out.append((tuple(addr), reply, t0, t1))

    threads = [threading.Thread(target=_pull, args=(a,), daemon=True)
               for a in addrs]
    for t in threads:
        t.start()
    deadline = monotonic() + timeout + grace_s
    for t in threads:
        t.join(timeout=max(0.1, deadline - monotonic()))
    return out


def gather_cluster_snapshots(gcs, nm_method: str, cw_method: str,
                             timeout: float, grace_s: float = 1.0,
                             call_kwargs: Optional[Dict[str, Any]] = None,
                             concurrent: bool = False):
    """The two-phase cluster gather both telemetry planes share:
    enumerate alive node managers + pubsub subscribers under the GCS
    lock, pull `nm_method` from every NM (each ships its own snapshot
    plus its workers' and names the worker addresses it covered), then
    pull `cw_method` from the remaining subscribers — drivers, and
    workers whose NM dropped out mid-collect. Returns
    (nm_replies, cw_replies, unreachable_node_ids) with replies in
    pull_snapshots' (addr, reply, t0, t1) form; per-snapshot
    annotation (clock offsets, tags) stays with the caller. One
    topology for spans_collect and metrics_collect, so a scheduling
    change (e.g. excluding draining nodes) can't silently diverge the
    planes. BOTH phases run under one overall deadline of
    timeout + grace_s: when unreachable NMs burn phase 1's budget, the
    subscriber phase gets only the remainder — an outage must not
    double the collect's worst case (the metrics sampler holds its
    round lock for this long against a 2s interval).

    `concurrent=True` runs both phases SIMULTANEOUSLY under the same
    deadline, skipping the covered-worker subtraction (callers dedupe
    by proc uid; peers reached twice must make the double call cheap —
    the profile plane's collect singleflight). This exists for gathers
    whose handlers BLOCK for a sampling window: serial phases would
    give drivers a different window than workers and double the
    wall-clock."""
    from time import monotonic
    deadline = monotonic() + timeout + grace_s
    with gcs._lock:
        nm_targets = [(nid, tuple(n.address))
                      for nid, n in gcs.nodes.items() if n.alive]
        sub_addrs = {tuple(addr)
                     for subs in gcs.subscribers.values()
                     for addr, _tok in subs}
    sub_addrs -= {a for _nid, a in nm_targets}  # NMs answer nm_*, not cw_*

    if concurrent:
        nm_box: List[List[tuple]] = [[]]

        def _pull_nms() -> None:
            nm_box[0] = pull_snapshots(
                [a for _nid, a in nm_targets], nm_method,
                timeout=timeout, grace_s=grace_s,
                call_kwargs=call_kwargs)

        t = threading.Thread(target=_pull_nms, daemon=True)
        t.start()
        cw_replies = pull_snapshots(sorted(sub_addrs), cw_method,
                                    timeout=timeout, grace_s=grace_s,
                                    call_kwargs=call_kwargs)
        t.join(timeout=max(0.1, deadline - monotonic()))
        nm_replies = nm_box[0]
        answered = {addr for addr, _r, _t0, _t1 in nm_replies}
        unreachable = [nid for nid, a in nm_targets if a not in answered]
        return nm_replies, cw_replies, unreachable

    nm_replies = pull_snapshots([a for _nid, a in nm_targets], nm_method,
                                timeout=timeout, grace_s=grace_s,
                                call_kwargs=call_kwargs)
    answered = {addr for addr, _r, _t0, _t1 in nm_replies}
    unreachable = [nid for nid, a in nm_targets if a not in answered]
    covered: set = set()
    for _addr, reply, _t0, _t1 in nm_replies:
        covered.update(tuple(a) for a in reply.get("worker_addrs", ()))
    # healthy phase 1 leaves the full timeout + grace; a slow one
    # shrinks phase 2 down to a 0.5s floor
    remaining = max(0.5, deadline - monotonic())
    t2 = min(timeout, remaining)
    cw_replies = pull_snapshots(sorted(sub_addrs - covered), cw_method,
                                timeout=t2,
                                grace_s=min(grace_s, remaining - t2),
                                call_kwargs=call_kwargs)
    return nm_replies, cw_replies, unreachable


def dedupe_by_uid(snaps) -> List[Dict[str, Any]]:
    """First occurrence wins — callers order the concatenation by
    preference (own snapshot first, then the estimation-quality order
    that matters to them)."""
    seen: set = set()
    unique: List[Dict[str, Any]] = []
    for snap in snaps:
        uid = snap.get("proc_uid")
        if uid in seen:
            continue
        seen.add(uid)
        unique.append(snap)
    return unique


def snapshot() -> Dict[str, Any]:
    """This process's ring, with the clock pair the merger needs to map
    monotonic span times onto this process's wall clock (and from there,
    via the collector's RPC-midpoint offset estimate, onto one cluster
    timebase)."""
    dropped = _RING.sync_dropped_metric()
    return {
        "proc_uid": PROC_UID,
        "pid": os.getpid(),
        "label": _process_label or f"proc-{os.getpid()}",
        "node_id": _node_id,
        # sampled back-to-back: wall = mono + (wall_time - mono_time)
        "mono_time": perf_counter(),
        "wall_time": _wall_time(),
        "dropped": dropped,
        "spans": _RING.snapshot_records(),
    }


def snapshot_events(snap: Dict[str, Any],
                    trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Convert one snapshot to Chrome-trace events on the collector's
    timebase. `clock_offset_s` (set by the collector: estimated
    peer_wall - collector_wall) is subtracted so all processes share one
    clock; within a process, span ordering is exactly the monotonic
    clock's."""
    base = (snap["wall_time"] - snap["mono_time"]
            - snap.get("clock_offset_s", 0.0))
    pid = snap.get("label") or f"proc-{snap.get('pid')}"
    out: List[Dict[str, Any]] = []
    for rec in snap.get("spans", ()):
        ph, name, t0, dur, tid, tr, attrs = rec
        if trace_id is not None and tr != trace_id:
            continue
        args: Dict[str, Any] = dict(attrs) if attrs else {}
        if tr is not None:
            args["trace_id"] = tr
        ev: Dict[str, Any] = {
            "ph": ph, "cat": "span", "name": name,
            "pid": pid, "tid": tid,
            "ts": (base + t0) * 1e6,
            "args": args,
        }
        if ph == "X":
            ev["dur"] = max(dur, 0.0) * 1e6
        else:
            ev["s"] = "t"  # instant scope: thread
        out.append(ev)
    return out


def merge_snapshots(snaps: Iterable[Dict[str, Any]],
                    trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Merge per-process snapshots into one event list: dedupe processes
    reached via two fan-out paths, emit process_name metadata rows, and
    sort by aligned timestamp (Chrome/Perfetto want ts-ordered JSON)."""
    events: List[Dict[str, Any]] = []
    seen: set = set()
    for snap in snaps:
        if not snap or snap.get("proc_uid") in seen:
            continue
        seen.add(snap.get("proc_uid"))
        pid = snap.get("label") or f"proc-{snap.get('pid')}"
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": pid,
                     **({"node_id": snap["node_id"][:12]}
                        if snap.get("node_id") else {})},
        })
        events.extend(snapshot_events(snap, trace_id=trace_id))
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events
