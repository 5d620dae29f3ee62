"""Dashboard head: HTTP JSON endpoints over the state API.

reference parity: dashboard/head.py (aiohttp head hosting module routes)
+ dashboard/state_aggregator.py. Endpoints:

    GET /             — HTML overview (auto-refreshing tables)
    GET /api/cluster  — nodes + resource totals/available
    GET /api/nodes    — state.list_nodes()
    GET /api/tasks    — state.list_tasks() (+ ?state= filter)
    GET /api/actors   — state.list_actors()
    GET /api/workers  — state.list_workers()
    GET /api/objects  — state.list_objects() + store stats (+ the
                        unreachable-node list)
    GET /api/profile  — task-attributed cluster flamegraph (sampling
                        profiler fan-out; ?duration=&hz=&format=
                        speedscope|folded|raw&device=1 + id filters)
    GET /api/autoscaler — autoscaler v2 lifecycle: instance table +
                       recent transitions (autoscaler/v2.py)
    GET /api/ownership — ownership protocol: RefState/LeaseState rows,
                        held leases, transition-ring tails
                        (?object=<hex prefix>&limit=N)
    GET /api/memory   — owner-attributed cluster object table
                        (?group_by=callsite|actor|node|owner&top=N)
    GET /api/locks    — runtime lockdep: per-process traced-lock stats
                        + acquisition-order graphs (util/locks.py)
    GET /api/jobs     — job table from the GCS KV
    GET /api/summary  — task-state counts
    GET /metrics      — Prometheus exposition of the CLUSTER-merged
                        registry (every process's metrics harvested via
                        the GCS fan-out, labeled by proc/node; see
                        _private/metrics_plane.py). Falls back to this
                        process's own registry if the GCS is down.
    GET /api/metrics  — the same harvest as JSON: per-proc snapshots +
                        merged series (?history=1 → the GCS's in-memory
                        time-series ring instead)
    GET /api/goodput  — per-job productive/badput wall-time ledger
                        (?job=&window=secs; _private/goodput.py)
    GET /api/logs     — attributed cluster logs (one logs_query fan-out;
                        filters: node_id/worker_id/actor/task_id/
                        trace_id/level/match/tail/timeout)
    GET /api/postmortems — crash-postmortem summaries (?id=pm-... for
                        one full bundle)
    GET /api/serve/requests — serve request telemetry: slowest + errored
                        requests from every ingress proxy's ring
                        (?deployment=&errors=1&slowest=N; entries carry
                        trace ids + per-stage latency breakdowns)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict
from urllib.parse import parse_qs, urlparse

_PAGE_TEMPLATE = """<!doctype html>
<html><head><title>ray_tpu dashboard</title>
<meta http-equiv="refresh" content="5">
<style>
 body {{ font-family: monospace; margin: 2em; }}
 table {{ border-collapse: collapse; margin: 1em 0; }}
 td, th {{ border: 1px solid #999; padding: 2px 8px; text-align: left; }}
 h2 {{ margin-bottom: 0; }}
 nav a {{ margin-right: 1em; }}
</style></head>
<body><h1>ray_tpu dashboard</h1>
<nav><a href="/api/timeline">download chrome timeline</a>
<a href="/metrics">prometheus metrics</a>
<a href="/api/profile/stack">stack dumps</a></nav>
{content}
</body></html>"""


def _render_overview(head: "DashboardHead") -> str:
    """Server-rendered overview (reference dashboard/client — here a
    no-build-step page: meta-refresh + tables from the same JSON routes
    the API serves, so it works without JS and tests can assert on it)."""
    from html import escape

    def esc(v: Any) -> str:
        return escape(str(v))

    def table(title: str, header, rows) -> str:
        out = [f"<h2>{esc(title)}</h2><table>"]
        if header:
            out.append("<tr>" + "".join(
                f"<th>{esc(h)}</th>" for h in header) + "</tr>")
        for row in rows:
            out.append("<tr>" + "".join(
                f"<td>{c}</td>" for c in row) + "</tr>")
        out.append("</table>")
        return "".join(out)

    def safe(route: str, default):
        try:
            return head.route(route, {})
        except Exception:  # noqa: BLE001 — one broken section must not
            return default  # blank the whole page

    cluster = safe("/api/cluster", {"nodes": [], "resources_total": {},
                                    "resources_available": {}})
    summary = safe("/api/summary", {})
    actors = safe("/api/actors", [])
    workers = safe("/api/workers", [])
    events = safe("/api/events", [])
    jobs = safe("/api/jobs", [])

    parts = [
        table("cluster", None, [
            (esc(k), f"{esc(cluster['resources_available'].get(k, 0))} / "
                     f"{esc(v)} available")
            for k, v in cluster["resources_total"].items()]),
        table("nodes", ("id", "state", "head"), [
            (esc(n["node_id"][:12]), esc(n["state"]), esc(n["is_head"]))
            for n in cluster["nodes"]]),
        table("tasks", None, [(esc(k), esc(v))
                              for k, v in summary.items()]),
        table("actors", ("id", "class", "state"), [
            (esc(a["actor_id"][:12]), esc(a["class_name"]),
             esc(a["state"])) for a in actors[:50]]),
        table("workers", ("id", "pid", "busy on", "stack"), [
            (esc(w["worker_id"][:12]), esc(w["pid"]),
             esc(w.get("current_task") or "-"),
             f'<a href="/api/profile/stack?worker_id='
             f'{esc(w["worker_id"])}">dump</a>')
            for w in workers[:50]]),
        table("jobs", ("id", "status", "entrypoint"), [
            (esc(j.get("job_id", j.get("submission_id", "?"))),
             esc(j.get("status", "?")),
             esc(str(j.get("entrypoint", ""))[:80]))
            for j in (jobs if isinstance(jobs, list) else [])[:50]]),
        table("recent events", ("type", "message"), [
            (esc(e.get("event_type") or e.get("type") or "?"),
             esc(e.get("message", "")))
            for e in list(events)[-20:][::-1]]),
    ]
    return "".join(parts)


class _NoRoute(Exception):
    """Unknown dashboard route (distinct from downstream KeyErrors, which
    must surface as 500s, not 404s)."""


class DashboardHead:
    """Runs inside any process connected to the cluster (typically an
    actor started by start_dashboard)."""

    def __init__(self, port: int = 8265, host: str = "127.0.0.1"):
        head = self
        self._job_client = None

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, payload: Any, code: int = 200) -> None:
                body = json.dumps(payload, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urlparse(self.path)
                route = parsed.path.rstrip("/") or "/"
                try:
                    if route == "/metrics":
                        # cluster-merged exposition (the GCS-harvested
                        # registry of every process); the GCS's native
                        # wait-graph gauges replaced the per-scrape
                        # mirror that used to live here. A GCS blip
                        # degrades to this process's own registry
                        # rather than failing the scrape.
                        try:
                            from ray_tpu_torch.util import state
                            text = state.cluster_metrics_text()
                        except Exception:  # noqa: BLE001
                            from ray_tpu_torch.util.metrics import \
                                prometheus_text
                            text = prometheus_text()
                        body = text.encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/plain; version=0.0.4")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    if route == "/":
                        body = _PAGE_TEMPLATE.format(
                            content=_render_overview(head)).encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "text/html")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    if route == "/api/timeline":
                        import ray_tpu_torch
                        q = {k: v[0] for k, v
                             in parse_qs(parsed.query).items()}
                        # ?spans=1 merges the flight-recorder rings in;
                        # ?trace_id=<hex> exports one trace standalone
                        # (task + span records, so it implies spans=1 —
                        # same as the CLI's --trace-id)
                        trace_id = q.get("trace_id") or None
                        body = json.dumps(ray_tpu_torch.timeline(
                            spans=(q.get("spans", "") in ("1", "true")
                                   or trace_id is not None),
                            trace_id=trace_id,
                        ), default=str).encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/json")
                        self.send_header(
                            "Content-Disposition",
                            'attachment; filename="timeline.json"')
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    params = {k: v[0] for k, v
                              in parse_qs(parsed.query).items()}
                    self._json(head.route(route, params))
                except _NoRoute:
                    self._json({"error": f"no route {route}"}, 404)
                except Exception as e:  # noqa: BLE001
                    self._json({"error": str(e)}, 500)

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="dashboard-http").start()

    def route(self, route: str, params: Dict[str, str]) -> Any:
        import ray_tpu_torch
        from ray_tpu_torch.util import state as s
        if route == "/api/cluster":
            return {
                "nodes": s.list_nodes(),
                "resources_total": ray_tpu_torch.cluster_resources(),
                "resources_available": ray_tpu_torch.available_resources(),
            }
        if route == "/api/nodes":
            return s.list_nodes()
        if route == "/api/tasks":
            filters = {"state": params["state"]} if "state" in params \
                else None
            return s.list_tasks(filters=filters)
        if route == "/api/actors":
            return s.list_actors()
        if route == "/api/workers":
            return s.list_workers()
        if route == "/api/objects":
            objs = s.list_objects()
            stats = s.object_store_stats()
            return {"objects": objs["objects"],
                    "store_stats": stats["stats"],
                    "unreachable": sorted(set(objs["unreachable"])
                                          | set(stats["unreachable"]))}
        if route == "/api/summary":
            return s.summarize_tasks()
        if route == "/api/profile/stack":
            # live stack dump (reference dashboard reporter module):
            # ?worker_id=<hex> for one worker, else every live worker
            # (one batched nm_profile_workers RPC per node)
            if "worker_id" in params:
                return s.profile_worker_stack(params["worker_id"])
            return s.profile_all_worker_stacks()
        if route == "/api/profile":
            # sampling profiler fan-out (_private/profiler.py):
            # ?duration=&hz=&format=speedscope|folded|raw plus the CLI's
            # node_id/worker_id/actor/trace_id filters; ?device=1 runs
            # jax profiler traces and reports xplane dirs
            out = s.profile(
                duration=float(params.get("duration", 5.0)),
                hz=float(params["hz"]) if "hz" in params else None,
                device=params.get("device") in ("1", "true"),
                node_id=params.get("node_id"),
                worker_id=params.get("worker_id"),
                actor=params.get("actor"),
                trace_id=params.get("trace_id"))
            fmt = params.get("format", "speedscope")
            if params.get("device") in ("1", "true") or fmt == "raw":
                return out
            from ray_tpu_torch._private import profiler as profiler_lib
            if fmt == "folded":
                return {"folded": profiler_lib.to_folded(
                    out["profiles"]),
                    "unreachable": out["unreachable"]}
            # extra top-level keys are ignored by the speedscope app,
            # so the unreachable-node list rides the payload rather
            # than being silently dropped (a merged flamegraph missing
            # a node must say so)
            return {**profiler_lib.to_speedscope(out["profiles"]),
                    "unreachable": out["unreachable"]}
        if route == "/api/locks":
            # runtime lockdep (ray_tpu/util/locks.py): per-process
            # traced-lock stats + acquisition-order graphs
            return s.locks(timeout=(float(params["timeout"])
                                    if "timeout" in params else None))
        if route == "/api/autoscaler":
            # autoscaler v2 lifecycle plane (autoscaler/v2.py):
            # instance table + recent lifecycle transitions
            return s.autoscaler_instances(
                limit=int(params["limit"]) if "limit" in params else 200)
        if route == "/api/ownership":
            # ownership protocol plane (_private/ownership.py):
            # ?object=<hex prefix> explains one object's state +
            # transitions; &limit=N caps per-process rows
            return s.ownership(
                object_id=params.get("object"),
                limit=int(params["limit"]) if "limit" in params else 200,
                timeout=(float(params["timeout"])
                         if "timeout" in params else None))
        if route == "/api/memory":
            # cluster object table (_private/memory_plane.py):
            # ?group_by=callsite|actor|node|owner&top=N
            return s.memory_table(
                group_by=params.get("group_by"),
                top=int(params["top"]) if "top" in params else None,
                timeout=(float(params["timeout"])
                         if "timeout" in params else None))
        if route == "/api/metrics":
            # harvested snapshots + merged series as JSON;
            # ?history=1 returns the GCS's in-memory time-series ring
            # (optionally ?names=prefix1,prefix2)
            if params.get("history") in ("1", "true"):
                names = [n for n in
                         params.get("names", "").split(",") if n]
                return s.metrics_history(names=names or None)
            return s.cluster_metrics()
        if route == "/api/goodput":
            # per-job productive/badput wall-time ledger
            # (_private/goodput.py; CLI: `ray_tpu goodput`):
            # ?job=<name> filters, ?window=<secs> reports the trailing
            # window via the durable history instead of job lifetime
            return s.goodput(
                job=params.get("job"),
                window_s=(float(params["window"])
                          if "window" in params else None))
        if route == "/api/metrics/config":
            from ray_tpu_torch.dashboard.metrics import write_metrics_configs
            return write_metrics_configs()
        if route == "/api/logs":
            # debug plane: one logs_query fan-out with server-side
            # filters (mirrors `ray_tpu logs`; see _private/log_plane.py)
            return s.logs(
                node_id=params.get("node_id"),
                worker_id=params.get("worker_id"),
                actor=params.get("actor"),
                task_id=params.get("task_id"),
                trace_id=params.get("trace_id"),
                level=params.get("level"),
                match=params.get("match"),
                tail=int(params.get("tail", 500)),
                timeout=(float(params["timeout"])
                         if "timeout" in params else None))
        if route == "/api/postmortems":
            # ?id=pm-... returns one full bundle; otherwise summaries
            if "id" in params:
                return s.get_postmortem(params["id"])
            return s.postmortems(limit=int(params.get("limit", 50)))
        if route == "/api/serve/requests":
            # serve request telemetry: slow/errored capture across all
            # ingress proxies (serve/_telemetry.py; CLI equivalent
            # `ray_tpu serve requests`)
            return s.serve_requests(
                deployment=params.get("deployment"),
                errors=params.get("errors") in ("1", "true"),
                slowest=(int(params["slowest"])
                         if "slowest" in params else None),
                timeout=float(params.get("timeout", 10.0)))
        if route == "/api/serve/fleet":
            # ingress fleet: per-node proxies, health/drain state,
            # admission snapshots (CLI: `ray_tpu serve fleet`)
            return s.serve_fleet()
        if route == "/api/wait_graph":
            # live actor waits-for edges + deadlocks-detected counter
            # (runtime counterpart of graftlint RT001)
            return s.wait_graph()
        if route == "/api/chaos":
            # installed chaos rules + cluster-wide fired counts
            # (_private/chaos.py; `ray_tpu chaos` CLI equivalent)
            return s.chaos_rules()
        if route == "/api/replay":
            # distributed replay plane: per-shard occupancy, adds,
            # priority updates, stale-ticket drops (rllib/utils/replay/;
            # CLI: `ray_tpu replay`)
            return s.replay_shards()
        if route == "/api/events":
            return s.list_cluster_events(
                event_type=params.get("type"),
                severity=params.get("severity"))
        if route == "/api/jobs":
            if self._job_client is None:
                from ray_tpu_torch.job import JobSubmissionClient
                self._job_client = JobSubmissionClient(
                    ray_tpu_torch.get_gcs_address())
            return self._job_client.list_jobs()
        raise _NoRoute(route)

    def ready(self) -> int:
        return self.port

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()  # release the listening socket fd


def start_dashboard(port: int = 8265, host: str = "127.0.0.1"):
    """Start the dashboard as an actor pinned to THIS node (a free-
    floating actor on a multi-node cluster would bind loopback on some
    other machine and be reachable from nowhere); returns its handle
    (call .ready.remote() for the bound port). Pass host="0.0.0.0" to
    serve off-node."""
    import ray_tpu_torch
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)
    cls = ray_tpu_torch.remote(DashboardHead)
    here = ray_tpu_torch.get_runtime_context().get_node_id()
    dash = cls.options(
        num_cpus=0.1, max_concurrency=4,
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=here)).remote(port, host)
    # generous readiness window: on a loaded CI box the spawn can sit
    # behind a full worker pool (and occasionally ride a lease retry)
    ray_tpu_torch.get(dash.ready.remote(), timeout=180)
    return dash
