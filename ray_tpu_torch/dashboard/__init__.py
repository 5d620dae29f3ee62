"""ray_tpu_torch.dashboard: cluster observability over HTTP.

reference parity: dashboard/head.py + modules (node, actor, job, state,
metrics — SURVEY §8.5): an HTTP server exposing the cluster state the
CLI reads, as JSON endpoints plus a minimal HTML overview. The React
client is out of scope; every JSON endpoint maps 1:1 onto a state-API
call so any frontend can sit on top.
"""

from ray_tpu_torch.dashboard.head import DashboardHead, start_dashboard  # noqa: F401

__all__ = ["DashboardHead", "start_dashboard"]
