"""Metrics-stack wiring: Prometheus scrape config + Grafana dashboard.

reference parity: dashboard/modules/metrics/ — the reference ships a
prometheus.yml pointed at the cluster's metric endpoints and generated
Grafana dashboard JSONs (grafana_dashboard_factory.py); `ray metrics
launch-prometheus` style tooling consumes them. Here
write_metrics_configs() materializes both under the session dir so an
operator (or the bundled docker-compose in real deployments) can point
Prometheus/Grafana at a running cluster with zero hand-editing.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

# Curated panels, kept stable across releases: external Grafana boards
# reference these exprs (the wait-graph gauges are now exported natively
# by the GCS and harvested onto the merged /metrics endpoint, so the
# exprs keep working without the old per-scrape mirror).
BASE_PANELS: List[Dict[str, Any]] = [
    {"title": "Tasks finished/sec", "type": "timeseries",
     "targets": [{"expr": "rate(ray_tpu_tasks_finished_total[1m])"}]},
    {"title": "Queued leases", "type": "timeseries",
     "targets": [{"expr": "ray_tpu_pending_leases"}]},
    {"title": "Object store bytes", "type": "timeseries",
     "targets": [{"expr": "ray_tpu_object_store_used_bytes"}]},
    {"title": "Live workers", "type": "timeseries",
     "targets": [{"expr": "ray_tpu_num_workers"}]},
    {"title": "Actor calls/sec", "type": "timeseries",
     "targets": [{"expr": "rate(ray_tpu_actor_calls_total[1m])"}]},
    {"title": "Train tokens/sec", "type": "timeseries",
     "targets": [{"expr": "ray_tpu_train_tokens_per_second"}]},
    {"title": "Actor wait edges (blocking gets)", "type": "timeseries",
     "targets": [{"expr": "ray_tpu_wait_graph_edges"}]},
    {"title": "Deadlocks detected", "type": "timeseries",
     "targets": [{"expr": "ray_tpu_deadlocks_detected"}]},
    # Serve request telemetry (serve/_telemetry.py): RED per deployment
    {"title": "Serve requests/sec by code", "type": "timeseries",
     "targets": [{"expr": "sum by (code) "
                          "(rate(ray_tpu_serve_requests_total[1m]))"}]},
    {"title": "Serve p99 latency by deployment", "type": "timeseries",
     "targets": [{"expr": "histogram_quantile(0.99, sum by "
                          "(le, deployment) (rate("
                          "ray_tpu_serve_request_seconds_bucket[5m])))"}]},
    {"title": "Serve p99 queue time by deployment", "type": "timeseries",
     "targets": [{"expr": "histogram_quantile(0.99, sum by "
                          "(le, deployment) (rate("
                          "ray_tpu_serve_queue_seconds_bucket[5m])))"}]},
    {"title": "Serve replica queue depth", "type": "timeseries",
     "targets": [{"expr": "sum by (deployment) "
                          "(ray_tpu_serve_replica_queue_depth)"}]},
    # Ingress fleet admission control (serve/_private/proxy_fleet/):
    # shed rate next to admitted rate = the brownout picture
    {"title": "Serve shed/sec by deployment+reason", "type": "timeseries",
     "targets": [{"expr": "sum by (deployment, reason) "
                          "(rate(ray_tpu_serve_shed_total[1m]))"}]},
]


def generated_panels(metrics: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One panel per metric actually present in a harvest (wire-format
    snapshots from util.state.cluster_metrics()["merged"] or any
    process's collect_wire()): counters get a rate() expr, gauges a
    plain expr, histograms a p99 quantile over the cumulative buckets —
    so the dashboard grows with the registry instead of hand-editing."""
    covered = {t["expr"] for p in BASE_PANELS for t in p["targets"]}
    panels: List[Dict[str, Any]] = []
    seen: set = set()
    for m in sorted(metrics, key=lambda m: m["name"]):
        name, kind = m["name"], m["kind"]
        if name in seen:
            continue
        seen.add(name)
        if kind == "counter":
            expr = f"rate({name}[1m])"
            title = f"{name} /sec"
        elif kind == "histogram":
            expr = (f"histogram_quantile(0.99, "
                    f"sum by (le) (rate({name}_bucket[1m])))")
            title = f"{name} p99"
        else:
            expr = name
            title = name
        if expr in covered:
            continue
        panels.append({"title": title, "type": "timeseries",
                       "targets": [{"expr": expr}],
                       "description": m.get("description", "")})
    return panels


def grafana_dashboard(metrics: Optional[List[Dict[str, Any]]] = None
                      ) -> Dict[str, Any]:
    return {
        "title": "ray_tpu cluster",
        "uid": "ray-tpu-default",
        "timezone": "browser",
        "refresh": "10s",
        "panels": BASE_PANELS + generated_panels(metrics or []),
    }


# Backwards-compatible module constant (static variant, no harvest).
GRAFANA_DASHBOARD: Dict[str, Any] = grafana_dashboard()


def prometheus_config(targets: List[str]) -> Dict[str, Any]:
    return {
        "global": {"scrape_interval": "10s"},
        "scrape_configs": [{
            "job_name": "ray_tpu",
            "metrics_path": "/metrics",
            "static_configs": [{"targets": targets}],
        }],
    }


def _yaml_dump(obj: Any, indent: int = 0) -> str:
    """Minimal YAML emitter for the scrape config (no pyyaml dep)."""
    pad = "  " * indent
    if isinstance(obj, dict):
        lines = []
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.append(_yaml_dump(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {json.dumps(v)}")
        return "\n".join(lines)
    if isinstance(obj, list):
        lines = []
        for item in obj:
            if isinstance(item, (dict, list)):
                body = _yaml_dump(item, indent + 1)
                first, _, rest = body.partition("\n")
                lines.append(f"{pad}- {first.strip()}")
                if rest:
                    lines.append(rest)
            else:
                lines.append(f"{pad}- {json.dumps(item)}")
        return "\n".join(lines)
    return f"{pad}{json.dumps(obj)}"


def write_metrics_configs(out_dir: Optional[str] = None,
                          dashboard_port: int = 8265) -> Dict[str, str]:
    """Write prometheus.yml + grafana dashboard JSON; returns paths.
    The single scrape target is the dashboard head's /metrics, which now
    serves the CLUSTER-merged registry (one endpoint covers every
    process); panels are generated from the series actually harvested
    when a cluster is reachable, falling back to the curated set."""
    import ray_tpu_torch
    if out_dir is None:
        w = ray_tpu_torch._private.worker.global_worker()
        out_dir = os.path.join(w.session_dir, "metrics")
    os.makedirs(out_dir, exist_ok=True)
    targets = [f"127.0.0.1:{dashboard_port}"]
    prom_path = os.path.join(out_dir, "prometheus.yml")
    with open(prom_path, "w", encoding="utf-8") as f:
        f.write(_yaml_dump(prometheus_config(targets)) + "\n")
    try:
        from ray_tpu_torch.util import state
        harvested = state.cluster_metrics()["merged"]
    except Exception:  # noqa: BLE001 - not connected: static panels
        harvested = []
    graf_path = os.path.join(out_dir, "grafana_dashboard.json")
    with open(graf_path, "w", encoding="utf-8") as f:
        json.dump(grafana_dashboard(harvested), f, indent=1)
    return {"prometheus": prom_path, "grafana_dashboard": graf_path}
