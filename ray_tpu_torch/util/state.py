"""Cluster state introspection API (`ray list tasks/actors/objects/...`).

reference parity: python/ray/util/state/api.py — list_* entry points backed
by the GCS task sink (gcs_task_manager.h:85) and per-node queries, aggregated
like dashboard/state_aggregator.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import rpc as rpc_lib
from ray_tpu_torch._private import worker as worker_mod


def _gcs():
    return worker_mod.global_worker().core_worker._gcs


def _pool():
    return worker_mod.global_worker().core_worker._pool


def list_tasks(filters: Optional[Dict[str, Any]] = None,
               limit: int = 10000) -> List[Dict[str, Any]]:
    """Task records with state transitions + timestamps."""
    # Flush this process's buffered events first so a list right after a
    # get() sees the terminal state.
    worker_mod.global_worker().core_worker.task_events.flush()
    return _gcs().call("list_tasks", filters=filters, limit=limit)


def list_actors(filters: Optional[Dict[str, Any]] = None
                ) -> List[Dict[str, Any]]:
    infos = _gcs().call("list_actors")
    out = [{
        "actor_id": a.actor_id.hex(),
        "class_name": a.class_name,
        "name": a.name,
        "namespace": a.namespace,
        "state": a.state,
        "node_id": a.node_id.hex() if a.node_id else None,
        "num_restarts": a.num_restarts,
        "death_cause": a.death_cause,
    } for a in infos]
    if filters:
        out = [r for r in out
               if all(r.get(k) == v for k, v in filters.items())]
    return out


def list_nodes() -> List[Dict[str, Any]]:
    return [{
        "node_id": n.node_id.hex(),
        "state": "ALIVE" if n.alive else "DEAD",
        "address": n.address,
        "is_head": n.is_head,
        "resources_total": dict(n.resources_total),
        "labels": dict(n.labels),
    } for n in _gcs().call("get_all_nodes")]


def list_workers() -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for n in _gcs().call("get_all_nodes"):
        if not n.alive:
            continue
        try:
            out.extend(_pool().get(tuple(n.address)).call("nm_list_workers"))
        except Exception:  # noqa: BLE001 - node died mid-listing
            pass
    return out


def _workers_by_node() -> Dict[Any, List[Dict[str, Any]]]:
    out: Dict[Any, List[Dict[str, Any]]] = {}
    for n in _gcs().call("get_all_nodes"):
        if not n.alive:
            continue
        try:
            out[tuple(n.address)] = _pool().get(
                tuple(n.address)).call("nm_list_workers")
        except Exception:  # noqa: BLE001 - node died mid-listing; treated as absent
            pass
    return out


def profile_worker_stack(worker_id: str,
                         timeout: float = 3.0) -> Dict[str, Any]:
    """Live all-thread stack dump of one worker (reference: dashboard
    reporter module / `ray stack` CLI, scripts.py:1810): resolves the
    worker's node and asks its node manager to SIGUSR1 the process and
    return the faulthandler dump."""
    for addr, workers in _workers_by_node().items():
        if any(w["worker_id"] == worker_id for w in workers):
            return _pool().get(addr).call(
                "nm_profile_worker", worker_id_hex=worker_id,
                timeout=timeout)
    raise KeyError(f"worker {worker_id[:12]} not found on any "
                   f"alive node")


def profile_all_worker_stacks(timeout: float = 3.0
                              ) -> List[Dict[str, Any]]:
    """Stack dumps for every live worker: ONE `nm_profile_workers` RPC
    per node — each node signals and collects all its workers in
    parallel — fanned out across nodes under a single overall deadline
    (the per-worker serial round trips this replaces scaled as
    nodes x workers). Nodes that don't answer contribute an error
    entry instead of stalling the dump."""
    from ray_tpu_torch._private import spans as spans_lib
    alive = [n for n in _gcs().call("get_all_nodes") if n.alive]
    replies = spans_lib.pull_snapshots(
        [tuple(n.address) for n in alive], "nm_profile_workers",
        timeout=timeout + 2.0, call_kwargs={"timeout": timeout})
    answered = {addr for addr, _r, _t0, _t1 in replies}
    out: List[Dict[str, Any]] = []
    for _addr, reply, _t0, _t1 in replies:
        out.extend(reply.get("dumps", ()))
    for n in alive:
        if tuple(n.address) not in answered:
            out.append({"worker_id": None, "pid": None, "stack": "",
                        "node_id": n.node_id.hex(),
                        "error": "node unreachable within deadline"})
    return out


def list_objects() -> Dict[str, Any]:
    """Objects resident in every alive node's shared-memory store:
    {"objects": [...], "unreachable": [node ids]} — like logs_query, a
    node that doesn't answer is NAMED rather than silently absent (an
    empty-looking store on an unreachable node is not an empty store)."""
    out: List[Dict[str, Any]] = []
    unreachable: List[str] = []
    for n in _gcs().call("get_all_nodes"):
        if not n.alive:
            continue
        try:
            for rec in _pool().get(tuple(n.store_address)).call("store_list"):
                rec["node_id"] = n.node_id.hex()
                out.append(rec)
        except Exception:  # noqa: BLE001 - named in the reply instead
            unreachable.append(n.node_id.hex())
    return {"objects": out, "unreachable": unreachable}


def list_placement_groups() -> List[Dict[str, Any]]:
    return [{
        "placement_group_id": pg.pg_id.hex(),
        "name": pg.name,
        "state": pg.state,
        "strategy": pg.strategy,
        "bundles": list(pg.bundles),
        "bundle_nodes": list(pg.bundle_nodes),
    } for pg in _gcs().call("list_placement_groups")]


def summarize_tasks() -> Dict[str, int]:
    """Count of tasks per state (reference `ray summary tasks`)."""
    counts: Dict[str, int] = {}
    for rec in list_tasks():
        counts[rec.get("state", "?")] = counts.get(rec.get("state", "?"), 0) + 1
    return counts


def wait_graph() -> Dict[str, Any]:
    """Live actor waits-for graph + deadlocks-detected counter (the
    runtime counterpart of graftlint's RT001: blocking gets between
    actors, detected as they happen; see _private/wait_graph.py)."""
    return _gcs().call("wait_graph_snapshot")


def spans_snapshots() -> List[Dict[str, Any]]:
    """Every process's flight-recorder ring, clock-offset annotated
    (the raw material behind `ray_tpu timeline --spans`; see
    _private/spans.py)."""
    return _gcs().call("spans_collect")


def _resolve_actor_filter(actor: Optional[str]) -> Optional[str]:
    """`ray_tpu logs --actor` accepts a name or an id (prefix): names
    resolve through the GCS actor directory (newest matching actor
    wins — restarts keep the id, re-creations get the newest)."""
    if not actor:
        return None
    for a in reversed(list_actors()):
        if a["name"] == actor:
            return a["actor_id"]
    return actor  # treat as an id (prefix)


def logs(node_id: Optional[str] = None, worker_id: Optional[str] = None,
         actor: Optional[str] = None, actor_id: Optional[str] = None,
         task_id: Optional[str] = None, trace_id: Optional[str] = None,
         level: Optional[str] = None, match: Optional[str] = None,
         tail: int = 500, timeout: Optional[float] = None
         ) -> Dict[str, Any]:
    """Cluster log query (`ray_tpu logs`, dashboard /api/logs): ONE GCS
    fan-out round — node managers serve their filtered tail indexes,
    drivers their in-process rings — under a single overall deadline.
    Filters run server-side; `actor` takes a name or id. Returns
    {"records": [...], "unreachable": [node ids]}; each record carries
    node/worker/task/actor ids + trace id + level (log_plane.py)."""
    filters: Dict[str, Any] = {}
    if node_id:
        filters["node_id"] = node_id
    if worker_id:
        filters["worker_id"] = worker_id
    resolved = _resolve_actor_filter(actor) or actor_id
    if resolved:
        filters["actor_id"] = resolved
    if task_id:
        filters["task_id"] = task_id
    if trace_id:
        filters["trace_id"] = trace_id
    if level:
        filters["level"] = level
    if match:
        filters["match"] = match
    return _gcs().call("logs_query", filters=filters or None, tail=tail,
                       timeout=timeout)


def follow_logs(node_id: Optional[str] = None,
                worker_id: Optional[str] = None,
                actor: Optional[str] = None,
                actor_id: Optional[str] = None,
                task_id: Optional[str] = None,
                trace_id: Optional[str] = None,
                level: Optional[str] = None, match: Optional[str] = None,
                duration: Optional[float] = None,
                poll_timeout: float = 0.5):
    """Generator over NEW log records as they stream off the cluster's
    `worker_logs` pubsub channel (the same feed `log_to_driver`
    prints), filtered client-side with the query plane's filter set.
    Runs until `duration` elapses (forever when None — the CLI's
    --follow mode, ended by ^C)."""
    import queue as _queue
    import time as _time

    from ray_tpu_torch._private import log_plane
    filters: Dict[str, Any] = {}
    for k, v in (("node_id", node_id), ("worker_id", worker_id),
                 ("actor_id", _resolve_actor_filter(actor) or actor_id),
                 ("task_id", task_id), ("trace_id", trace_id),
                 ("level", level), ("match", match)):
        if v:
            filters[k] = v
    q: "_queue.Queue" = _queue.Queue()
    live = [True]

    def _on_msg(msg):
        if live[0]:
            q.put(msg)

    cw = worker_mod.global_worker().core_worker
    token = cw.subscribe("worker_logs", _on_msg)
    deadline = None if duration is None else _time.monotonic() + duration
    try:
        while deadline is None or _time.monotonic() < deadline:
            try:
                msg = q.get(timeout=poll_timeout)
            except _queue.Empty:
                continue
            for rec in log_plane.filter_records(
                    msg.get("records") or (), filters):
                yield rec
    finally:
        live[0] = False
        # tear the subscription down end to end (callback + the GCS
        # entry) so repeated follows don't multiply the publish fan-out
        try:
            cw.unsubscribe("worker_logs", token)
        except Exception:  # noqa: BLE001 - cluster gone mid-follow
            pass


def postmortems(limit: int = 50) -> List[Dict[str, Any]]:
    """Crash-postmortem summaries from the GCS's bounded ring, newest
    last (worker/actor deaths bundled by the node manager, task
    failures by the executor). Fetch one bundle — last log lines, span
    tail, gauges — with get_postmortem(id)."""
    return _gcs().call("postmortem_list", limit=limit)


def get_postmortem(postmortem_id: str) -> Optional[Dict[str, Any]]:
    """One full postmortem bundle (log_tail + span_tail included), or
    None if it aged out of the ring."""
    return _gcs().call("postmortem_get", postmortem_id=postmortem_id)


def serve_requests(deployment: Optional[str] = None,
                   errors: bool = False,
                   slowest: Optional[int] = None,
                   timeout: float = 10.0) -> Dict[str, Any]:
    """Captured serve requests from every ingress proxy's bounded ring
    (`ray_tpu serve requests`, dashboard /api/serve/requests): the
    slowest and all errored requests, each with its trace id,
    deployment, status code, per-stage latency breakdown, and error.
    Proxies self-register as named actors (SERVE_PROXY_*, namespace
    "serve"); ones that don't answer are named in `unreachable` — an
    empty capture from an unreachable proxy is not an empty capture.
    `errors=True` restricts to errored requests; `slowest=N` returns
    the N slowest across all proxies; `deployment` filters either
    view."""
    import ray_tpu_torch
    entries: List[Dict[str, Any]] = []
    proxies = 0
    unreachable: List[str] = []
    pending: List[tuple] = []  # (proxy name, snapshot ref)
    for a in list_actors():
        name = a.get("name") or ""
        if a.get("state") == "DEAD" or \
                not name.startswith("SERVE_PROXY_"):
            continue
        try:
            h = ray_tpu_torch.get_actor(name, namespace=a.get("namespace")
                                  or "serve")
            pending.append((name, h.requests_snapshot.remote(
                deployment=deployment, errors=errors,
                slowest=slowest)))
        except Exception:  # noqa: BLE001 - named in the reply instead
            unreachable.append(name)
    if pending:
        # one batched wait bounds the whole fan-out by `timeout`
        # instead of timeout x proxies
        ready, _ = ray_tpu_torch.wait([r for _n, r in pending],
                                num_returns=len(pending),
                                timeout=timeout)
        ready_set = {r.hex() for r in ready}
        for name, ref in pending:
            if ref.hex() not in ready_set:
                unreachable.append(name)
                continue
            try:
                # ready refs: the get is a local materialize, zero
                # extra round trips
                entries.extend(  # graftlint: disable=RT002
                    ray_tpu_torch.get(ref, timeout=timeout))
                proxies += 1
            except Exception:  # noqa: BLE001 - named in the reply instead
                unreachable.append(name)
    if slowest is not None:
        # composes with errors=True: the N slowest ERRORED requests
        entries.sort(key=lambda e: e.get("total_s") or 0.0,
                     reverse=True)
        entries = entries[:slowest]
    else:
        entries.sort(key=lambda e: e.get("ts") or 0.0)
    return {"requests": entries, "proxies": proxies,
            "unreachable": unreachable}


def serve_fleet() -> Dict[str, Any]:
    """Ingress fleet state (serve/_private/proxy_fleet/): per-node
    proxies with ports, health, drain flags, plus each live proxy's
    admission snapshot (in-flight counts, limits, shed totals). CLI:
    `ray_tpu serve fleet`; dashboard: /api/serve/fleet."""
    import ray_tpu_torch
    from ray_tpu_torch.serve._private.proxy_fleet.fleet import (
        PROXY_NAME_PREFIX)
    try:
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER",
                                       namespace="serve")
    except Exception:  # noqa: BLE001 - serve not running
        return {"enabled": False, "proxies": []}
    status = ray_tpu_torch.get(controller.fleet_status.remote(), timeout=30)
    # enrich with live admission snapshots, one batched wait
    pending = []
    for p in status.get("proxies", ()):
        try:
            h = ray_tpu_torch.get_actor(
                f"{PROXY_NAME_PREFIX}{p['node_id'][:12]}",
                namespace="serve")
            pending.append((p, h.status.remote()))
        except Exception:  # noqa: BLE001 - proxy mid-replacement
            p["admission"] = None
    if pending:
        ready, _ = ray_tpu_torch.wait([r for _p, r in pending],
                                num_returns=len(pending), timeout=10)
        ready_set = {r.hex() for r in ready}
        for p, ref in pending:
            if ref.hex() in ready_set:
                try:
                    # ready refs: local materialize, zero extra RPCs
                    live = ray_tpu_torch.get(ref, timeout=10)  # graftlint: disable=RT002
                    p["admission"] = live.get("admission")
                    p["inflight"] = live.get("inflight")
                    p["shed_total"] = live.get("shed_total")
                except Exception:  # noqa: BLE001 - died mid-query
                    p["admission"] = None
            else:
                p["admission"] = None
    return status


def replay_shards() -> Dict[str, Any]:
    """Distributed replay plane state (rllib/utils/replay/): every live
    ReplayShardActor found in the actor registry, enriched with each
    shard's own stats() snapshot (size, added, evicted, priority
    updates, unmatched tickets). CLI: `ray_tpu replay`; dashboard:
    /api/replay."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib.utils.replay import REPLAY_NAMESPACE

    records = list_actors(filters={"class_name": "ReplayShardActor"})
    shards: List[Dict[str, Any]] = []
    pending = []
    for rec in records:
        row: Dict[str, Any] = {
            "actor_id": rec["actor_id"],
            "name": rec["name"],
            "state": rec["state"],
            "node_id": rec["node_id"],
            "num_restarts": rec["num_restarts"],
            "stats": None,
        }
        shards.append(row)
        if rec["state"] != "ALIVE" or not rec["name"]:
            continue
        try:
            h = ray_tpu_torch.get_actor(rec["name"],
                                        namespace=REPLAY_NAMESPACE)
            pending.append((row, h.stats.remote()))
        except Exception:  # noqa: BLE001 - died mid-listing
            pass
    if pending:
        ready, _ = ray_tpu_torch.wait([r for _row, r in pending],
                                      num_returns=len(pending), timeout=10)
        ready_set = {r.hex() for r in ready}
        for row, ref in pending:
            if ref.hex() in ready_set:
                try:
                    # ready refs: local materialize, zero extra RPCs
                    row["stats"] = ray_tpu_torch.get(  # graftlint: disable=RT002
                        ref, timeout=10)
                except Exception:  # noqa: BLE001 - died mid-query
                    pass
    live = [s["stats"] for s in shards if s["stats"]]
    return {
        "num_shards": len(shards),
        "num_alive": sum(1 for s in shards if s["state"] == "ALIVE"),
        "total_size": sum(s["size"] for s in live),
        "total_added": sum(s["added"] for s in live),
        "total_unmatched_priority_updates": sum(
            s["unmatched_priority_updates"] for s in live),
        "shards": shards,
    }


def chaos_rules() -> Dict[str, Any]:
    """Installed chaos rules + cluster-wide fired counts (the runtime
    view behind `ray_tpu chaos list` and the dashboard /api/chaos)."""
    return _gcs().call("chaos_list")


def cluster_metrics(fresh: bool = False) -> Dict[str, Any]:
    """Cluster-wide metrics: per-process registry snapshots (harvested
    GCS → node managers → workers, plus drivers) and the cluster-merged
    series/wire views (_private/metrics_plane.py), all from ONE harvest
    round so the views are mutually consistent. Backs the dashboard
    /api/metrics route and `ray_tpu metrics dump --format=json`;
    `fresh=True` forces a harvest-NOW fan-out first, like
    cluster_metrics_text(fresh=True)."""
    return _gcs().call("metrics_merged", fresh=fresh)


def cluster_metrics_text(fresh: bool = False) -> str:
    """The cluster-merged registry in Prometheus exposition format —
    what the dashboard /metrics endpoint serves: every harvested series
    labeled by proc + node, histogram buckets cumulative. Scrapes ride
    the GCS sampler's last round (at most one sample interval stale);
    `fresh=True` forces a harvest-NOW fan-out first — for operators
    and tests that just induced the state they want to see."""
    return _gcs().call("metrics_prometheus", force=fresh)


def metrics_history(names: Optional[List[str]] = None,
                    limit: Optional[int] = None) -> Dict[str, Any]:
    """Recent samples from the GCS's in-memory time-series ring
    ({"interval_s", "samples": [(wall_ts, {series: value}), ...]}) —
    rates/deltas/sparklines for `ray_tpu top` without an external
    Prometheus."""
    return _gcs().call("metrics_history", names=names, limit=limit)


def metrics_history_range(names: Optional[List[str]] = None,
                          since_s: float = 600.0,
                          tier: str = "raw") -> Dict[str, Any]:
    """Lookback-window read of the GCS's durable tiered history
    (_private/metrics_history.py): samples with wall ts within the last
    `since_s` seconds from `tier` ("raw" | "30s" | "5min"), reaching
    through the on-disk segments — including ones replayed from before
    a GCS restart. Downsampled tiers carry counters as per-window
    deltas and gauges as [min, mean, max]."""
    return _gcs().call("metrics_history_range", names=names,
                       since_s=since_s, tier=tier)


def goodput(job: Optional[str] = None,
            window_s: Optional[float] = None,
            fresh: bool = False) -> Dict[str, Any]:
    """Per-job goodput/badput ledger view (_private/goodput.py):
    lifetime bucket totals from the harvested
    `ray_tpu_goodput_seconds_total{job,bucket}` series plus each live
    ledger's in-flight snapshot (current bucket + age), with
    productive fraction per job. `window_s` restricts the totals to
    the recent window by diffing the durable raw history tier instead
    of lifetime counters. `fresh=True` harvests NOW first (sub-second
    view for tests/CLI)."""
    from ray_tpu_torch._private.goodput import METRIC, SNAPSHOT_KEY
    merged = cluster_metrics(fresh=fresh)
    prefix = METRIC + "{"

    def _tags(key: str) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for part in key[len(prefix):-1].split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                out[k] = v
        return out

    def _collect(series: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
        jobs: Dict[str, Dict[str, float]] = {}
        for key, v in series.items():
            if not (key.startswith(prefix) and key.endswith("}")):
                continue
            if isinstance(v, (list, tuple)):
                v = v[1]  # downsampled gauge artifact; counters are flat
            tags = _tags(key)
            j, b = tags.get("job"), tags.get("bucket")
            if j and b:
                jobs.setdefault(j, {})[b] = \
                    jobs.get(j, {}).get(b, 0.0) + float(v)
        return jobs

    totals = _collect(merged.get("series", {}))
    if window_s is not None:
        hist = metrics_history_range(names=[METRIC],
                                     since_s=float(window_s),
                                     tier="raw")
        samples = hist.get("samples") or []
        if samples:
            base = _collect(samples[0][1])
            for j, buckets in totals.items():
                jb = base.get(j, {})
                for b in list(buckets):
                    buckets[b] = max(0.0,
                                     buckets[b] - jb.get(b, 0.0))
    # live in-flight snapshots ride the harvest as a snapshot extra
    inflight: Dict[str, Any] = {}
    for snap in merged.get("procs", ()):
        extra = snap.get(SNAPSHOT_KEY)
        if extra:
            for j, view in (extra.get("jobs") or {}).items():
                inflight[j] = {"bucket": view.get("bucket"),
                               "bucket_age_s": view.get("bucket_age_s"),
                               "uptime_s": view.get("uptime_s"),
                               "proc": snap.get("proc")}
    jobs_out: Dict[str, Any] = {}
    names = set(totals) | set(inflight)
    for j in sorted(names):
        if job is not None and j != job:
            continue
        buckets = totals.get(j, {})
        accounted = sum(buckets.values())
        productive = buckets.get("productive_step", 0.0)
        jobs_out[j] = {
            "buckets": {b: round(v, 3)
                        for b, v in sorted(buckets.items())},
            "accounted_s": round(accounted, 3),
            "productive_s": round(productive, 3),
            "productive_frac": round(productive / accounted, 4)
            if accounted else None,
            "in_flight": inflight.get(j),
        }
    return {"ts": merged.get("ts"),
            "window_s": window_s,
            "jobs": jobs_out}


def metrics_configure(**knobs: Any) -> Dict[str, Any]:
    """Tune the GCS metrics plane + watchdog live, no restart
    (_private/metrics_plane.py configure): `interval_s`, `cooldown_s`,
    probe thresholds (`gang_heartbeat_stale_s`, `wait_edge_age_s`,
    ...), and the runtime `step_deadline_s` override every gang
    supervisor picks up on its next heartbeat query (<= 0 clears it,
    back to ScalingConfig / auto-calibration). Returns the effective
    settings."""
    return _gcs().call("metrics_configure", **knobs)


def health_alerts(limit: int = 100) -> List[Dict[str, Any]]:
    """HEALTH_ALERT events the metrics watchdog emitted (invariant
    probes over the harvested series; see _private/metrics_plane.py)."""
    return list_cluster_events(event_type="HEALTH_ALERT", limit=limit)


def emit_event(event_type: str, message: str = "",
               severity: str = "INFO", **fields: Any) -> None:
    """Application-level structured event into the cluster event table
    (reference util/event.h RayEvent / python event_logger). Best
    effort — telemetry must never break the caller."""
    from ray_tpu_torch._private.events import emit_via
    emit_via(_gcs().call, "app", event_type, message, severity, **fields)


def list_cluster_events(event_type: Optional[str] = None,
                        severity: Optional[str] = None,
                        limit: int = 1000) -> List[Dict[str, Any]]:
    """Structured lifecycle events (reference dashboard event module):
    node deaths, actor restarts, OOM kills, autoscaling actions."""
    return _gcs().call("list_events", event_type=event_type,
                       severity=severity, limit=limit)


def object_store_stats() -> Dict[str, Any]:
    """Per-node store stats incl. spill/restore counters (`ray memory`):
    {"stats": [...], "unreachable": [node ids]} — unreachable nodes are
    named, matching logs_query semantics."""
    out = []
    unreachable: List[str] = []
    for n in _gcs().call("get_all_nodes"):
        if not n.alive:
            continue
        try:
            stats = _pool().get(tuple(n.store_address)).call("store_stats")
            stats["node_id"] = n.node_id.hex()
            out.append(stats)
        except Exception:  # noqa: BLE001 - named in the reply instead
            unreachable.append(n.node_id.hex())
    return {"stats": out, "unreachable": unreachable}


def profile(duration: float = 5.0, hz: Optional[float] = None,
            device: bool = False,
            node_id: Optional[str] = None,
            worker_id: Optional[str] = None,
            actor: Optional[str] = None,
            trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Cluster CPU profile (`ray_tpu profile`, dashboard /api/profile):
    one GCS fan-out samples every process's threads for `duration`
    seconds at `hz`, task/actor/trace-attributed, merged clock-free.
    Returns {"profiles": [per-process folded-stack profiles],
    "unreachable": [node ids], ...} — render with
    profiler.to_speedscope / to_folded. Filters select processes by
    node/worker/actor id prefix (actor also takes a name) and stacks by
    trace id. device=True instead runs jax profiler traces on
    jax-initialized workers and reports xplane dirs."""
    from ray_tpu_torch._private import profiler as profiler_lib
    from ray_tpu_torch._private.config import Config
    out = _gcs().call("profile_collect",
                      duration_s=duration,
                      hz=float(hz if hz is not None
                               else Config.profile_default_hz),
                      device=device)
    if not device and (node_id or worker_id or actor or trace_id):
        out["profiles"] = profiler_lib.filter_profiles(
            out["profiles"], node_id=node_id, worker_id=worker_id,
            actor_id=_resolve_actor_filter(actor),
            trace_id=trace_id)
    return out


def ownership(object_id: Optional[str] = None, limit: int = 200,
              timeout: Optional[float] = None) -> Dict[str, Any]:
    """Cluster ownership-protocol view (`ray_tpu ownership`, dashboard
    /api/ownership; _private/ownership.py): every process's live
    RefState rows (what holds each object alive — local refs, arg/
    transit pins, borrower registrations, replica reader leases),
    per-scheduling-key LeaseState summaries (request slots, parked
    counts, held leases, pipeline depth), node managers' held leases +
    store reader-lease/pin residency, and each process's bounded
    transition-ring tail — so a stuck object explains itself.
    `object_id` (hex prefix) restricts rows and transitions to one
    object. Anomaly counts (`unmatched:*` / `illegal:*` transitions)
    are aggregated cluster-wide; unreachable nodes are named."""
    return _gcs().call("ownership_collect", object_id=object_id,
                       limit=limit, timeout=timeout)


def autoscaler_instances(limit: int = 200) -> Dict[str, Any]:
    """Autoscaler v2 lifecycle view (`ray_tpu autoscaler`, dashboard
    /api/autoscaler; autoscaler/v2.py): the latest instance table
    (instance id, node type, lifecycle status QUEUED/REQUESTED/
    ALLOCATED/RAY_RUNNING/TERMINATING/TERMINATED, retries, age in
    state) plus the most recent `limit` lifecycle transitions the
    autoscaler reported. Live subscribers use the
    "autoscaler_lifecycle" pubsub channel instead of polling this."""
    return _gcs().call("autoscaler_v2_state", limit=limit)


def locks(timeout: Optional[float] = None) -> Dict[str, Any]:
    """Cluster lockdep snapshot (`ray_tpu locks`, dashboard
    /api/locks): every process's traced locks (hold counts/times,
    current holders, threads waiting) and its acquisition-order edge
    graph, with any observed order-inversion cycle called out per
    process. Unreachable nodes are named — an empty lock list is only
    meaningful when coverage was complete."""
    return _gcs().call("locks_collect", timeout=timeout)


def memory_table(group_by: Optional[str] = None,
                 top: Optional[int] = None,
                 timeout: Optional[float] = None) -> Dict[str, Any]:
    """Cluster object table (`ray_tpu memory`): every object joined
    across its owner's reference table and the stores where bytes are
    resident — owner identity, local refs, borrower pins, reader
    leases, creation callsite (when RAY_TPU_memory_callsite_capture=1),
    and per-node residency (size/pinned/leases/age, primary vs
    replica). group_by aggregates rows by callsite|actor|node|owner;
    `top` keeps the N largest. Unreachable nodes are named."""
    from ray_tpu_torch._private import memory_plane as memory_plane_lib
    out = _gcs().call("memory_collect", timeout=timeout)
    out["total_objects"] = len(out["objects"])
    if top and not group_by:
        out["objects"] = out["objects"][:int(top)]
    if group_by:
        out["groups"] = memory_plane_lib.group_rows(
            out["objects"], group_by, top=top)
    return out
