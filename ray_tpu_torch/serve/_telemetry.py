"""Serve request telemetry: RED metrics, slow/error request ring,
ingress trace ids, and harvest-time queue-depth gauges.

reference parity: serve/_private/proxy.py + metrics_utils.py — the
reference instruments every request hop with deployment-tagged
latency/queue metrics and a request-context id. Here the same ledger
rides the existing planes: span-plane records at each hop (proxy
parse/route/write, handle submit, replica queue/execute), per-deployment
RED metrics through `util.metrics` (harvested onto the cluster-merged
/metrics endpoint by _private/metrics_plane.py), and a bounded per-proxy
ring of the slowest + all errored requests behind `ray_tpu serve
requests` / /api/serve/requests / util.state.serve_requests().

Ownership of the RED metrics (one observation per request per metric —
the merged endpoint must not double-count a request that crossed
several hops):

  - ``ray_tpu_serve_requests_total{deployment,code}`` — incremented at
    the INGRESS proxy (HTTP or gRPC), where the status code is decided;
    404s and 504s that never reach a replica are still counted.
  - ``ray_tpu_serve_request_seconds{deployment}`` — observed by the
    DeploymentHandle's completion callback (submit → result ready), so
    proxy traffic and direct handle calls (deployment composition,
    bench harnesses) land in the same histogram, and a request the
    proxy abandoned at its deadline still records its true latency.
  - ``ray_tpu_serve_queue_seconds{deployment}`` — observed by the
    replica (submit wall stamp → execution start: time spent queued in
    the handle/executor path).
  - gauges ``ray_tpu_serve_handle_queue_depth`` /
    ``ray_tpu_serve_replica_queue_depth`` — exported at harvest time
    via the metrics plane's register_sampler hook; the request hot path
    never touches them.
"""

from __future__ import annotations

import heapq
import re
import threading
import uuid
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util.locks import TracedLock

# Serve-appropriate latency buckets (the registry default tops out at
# 1000s and has no sub-10ms resolution; SLO p99s live in this range).
LATENCY_BOUNDARIES = [0.005, 0.025, 0.05, 0.1, 0.25, 0.5,
                      1.0, 2.5, 5.0, 10.0]

# Inbound X-Request-Id values are adopted verbatim only when they are
# shaped like an id — anything else (oversized, control chars, spoofed
# exposition-breaking bytes) is replaced by a minted id.
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


def mint_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def ingress_trace_id(header: Optional[str]) -> str:
    """The trace id for one ingress request: the inbound header when it
    is id-shaped, else a freshly minted one (always returned to the
    client in the response's X-Request-Id)."""
    if header and _TRACE_ID_RE.match(header):
        return header
    return mint_trace_id()


# ---------------------------------------------------------------------
# RED metrics (lazily created so merely importing serve registers
# nothing; get_or_create because proxy/handle/replica race on first use)
# ---------------------------------------------------------------------


def _counter():
    from ray_tpu_torch.util.metrics import Counter, get_or_create
    return get_or_create(
        Counter, "ray_tpu_serve_requests_total",
        description="serve ingress requests by deployment and status "
                    "code (counted at the HTTP/gRPC proxy)",
        tag_keys=("deployment", "code"))


def _request_hist():
    from ray_tpu_torch.util.metrics import Histogram, get_or_create
    return get_or_create(
        Histogram, "ray_tpu_serve_request_seconds",
        description="serve request latency, submit to result ready "
                    "(observed by the deployment handle)",
        boundaries=LATENCY_BOUNDARIES, tag_keys=("deployment",))


def _queue_hist():
    from ray_tpu_torch.util.metrics import Histogram, get_or_create
    return get_or_create(
        Histogram, "ray_tpu_serve_queue_seconds",
        description="serve time-in-queue, handle submit to replica "
                    "execution start (observed by the replica)",
        boundaries=LATENCY_BOUNDARIES, tag_keys=("deployment",))


def _shed_counter():
    from ray_tpu_torch.util.metrics import Counter, get_or_create
    return get_or_create(
        Counter, "ray_tpu_serve_shed_total",
        description="serve ingress requests shed by admission control "
                    "(503 + Retry-After / RESOURCE_EXHAUSTED), by "
                    "deployment and reason (capacity | rate_limit)",
        tag_keys=("deployment", "reason"))


def count_request(deployment: str, code: Any) -> None:
    try:
        _counter().inc(tags={"deployment": deployment,
                             "code": str(code)})
    except Exception:  # noqa: BLE001 - telemetry must never fail a request
        pass


def count_shed(deployment: str, reason: str) -> None:
    """One shed decision at an ingress proxy — first-class RED (the
    serve_shed_burn watchdog probe judges this counter's per-harvest
    delta against admitted traffic)."""
    try:
        _shed_counter().inc(tags={"deployment": deployment,
                                  "reason": reason})
    except Exception:  # noqa: BLE001 - telemetry must never fail a request
        pass


def observe_request(deployment: str, dur_s: float) -> None:
    try:
        _request_hist().observe(dur_s, tags={"deployment": deployment})
    except Exception:  # noqa: BLE001 - telemetry must never fail a request
        pass


def observe_queue(deployment: str, dur_s: float) -> None:
    try:
        _queue_hist().observe(dur_s, tags={"deployment": deployment})
    except Exception:  # noqa: BLE001 - telemetry must never fail a request
        pass


# ---------------------------------------------------------------------
# Slow/error request ring (one per proxy actor)
# ---------------------------------------------------------------------


class RequestRing:
    """Bounded capture of the requests an operator asks about first:
    every errored request (drop-oldest deque) plus the N slowest
    (min-heap on total latency). Entries are small dicts — trace id,
    deployment, method, code, per-stage breakdown, error string — and
    recording is O(log N) off the response path's critical section."""

    def __init__(self, errors_max: int = 128, slowest_max: int = 64):
        self._errors: "deque" = deque(maxlen=max(1, errors_max))
        self._slowest: List[tuple] = []  # (total_s, seq, entry) min-heap
        self._slowest_max = max(1, slowest_max)
        self._seq = 0
        self._lock = TracedLock("serve_request_ring")

    def record(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            if entry.get("error") is not None:
                self._errors.append(entry)
            item = (float(entry.get("total_s") or 0.0), self._seq, entry)
            if len(self._slowest) < self._slowest_max:
                heapq.heappush(self._slowest, item)
            elif item[0] > self._slowest[0][0]:
                heapq.heapreplace(self._slowest, item)

    def snapshot(self, deployment: Optional[str] = None,
                 errors: bool = False,
                 slowest: Optional[int] = None) -> List[Dict[str, Any]]:
        """Captured entries, oldest first. `errors=True` restricts to
        errored requests; `slowest=N` keeps the N slowest of the view
        (latency-descending) — the flags compose, so errors+slowest is
        the N slowest ERRORED requests; `deployment` filters any
        view."""
        with self._lock:
            errs = list(self._errors)
            slow = [e for _t, _s, e in self._slowest]
        if errors:
            out = errs
        elif slowest is not None:
            out = slow
        else:
            # merged view, deduped (an errored slow request is in both)
            seen: set = set()
            out = []
            for e in errs + slow:
                if e["seq"] in seen:
                    continue
                seen.add(e["seq"])
                out.append(e)
            out.sort(key=lambda e: e.get("ts") or 0.0)
        if deployment:
            out = [e for e in out if e.get("deployment") == deployment]
        if slowest is not None:
            out = sorted(out, key=lambda e: e.get("total_s") or 0.0,
                         reverse=True)[:slowest]
        return out


def record_ingress(ring: Optional[RequestRing], *, deployment: str,
                   method: str, code: Any, trace_id: str,
                   total_s: float, stages: Dict[str, float],
                   error: Optional[str] = None) -> Dict[str, Any]:
    """One ingress request's ledger entry: count it (RED), capture it
    (ring). `stages` must be COMPLETE when passed — the entry becomes
    visible to requests_snapshot() serialization the moment it is
    recorded, so callers must not mutate it afterwards (record after
    the response write, as both proxies do)."""
    import time
    count_request(deployment, code)
    entry = {
        "ts": time.time(),
        "trace_id": trace_id,
        "deployment": deployment,
        "method": method,
        "code": int(code),
        "error": error,
        "total_s": total_s,
        "stages": stages,
    }
    if ring is not None:
        try:
            ring.record(entry)
        except Exception:  # noqa: BLE001 - telemetry must never fail a request
            pass
    return entry


# ---------------------------------------------------------------------
# Harvest-time queue-depth gauges
# ---------------------------------------------------------------------

_handles: "weakref.WeakSet" = weakref.WeakSet()
_replicas: "weakref.WeakSet" = weakref.WeakSet()
# deployments whose gauge series this process has set: a deployment
# whose handles/replicas vanish must read 0, not freeze at its last
# nonzero depth (a phantom backlog on /metrics)
_gauged_handle_deps: set = set()
_gauged_replica_deps: set = set()
_sampler_installed = False
_sampler_lock = threading.Lock()


def _ensure_sampler() -> None:
    global _sampler_installed
    with _sampler_lock:
        if _sampler_installed:
            return
        _sampler_installed = True
    from ray_tpu_torch._private import metrics_plane
    metrics_plane.register_sampler("serve_telemetry", _sample_gauges)


def register_handle(handle: Any) -> None:
    """Track a DeploymentHandle for the harvest-time queue-depth gauge
    (weakly: an abandoned handle drops out on its own)."""
    _handles.add(handle)
    _ensure_sampler()


def register_replica(replica: Any) -> None:
    """Track a Replica instance for the harvest-time queue-depth gauge."""
    _replicas.add(replica)
    _ensure_sampler()


def _sample_gauges() -> None:
    """Export point-in-time serve queue depths at harvest time (the
    metrics plane calls this right before snapshotting the registry —
    the request hot path never pays for it)."""
    from ray_tpu_torch.util.metrics import Gauge, get_or_create
    handle_depth: Dict[str, float] = {}
    for h in list(_handles):
        try:
            with h._lock:
                n = sum(h._in_flight.values())
            handle_depth[h.deployment_name] = \
                handle_depth.get(h.deployment_name, 0.0) + n
        except Exception:  # noqa: BLE001 - a half-torn-down handle must
            pass           # not break the whole snapshot
    if handle_depth or _gauged_handle_deps:
        g = get_or_create(
            Gauge, "ray_tpu_serve_handle_queue_depth",
            description="in-flight serve requests tracked by this "
                        "process's deployment handles",
            tag_keys=("deployment",))
        # vanished deployments read 0, not their last nonzero depth
        for dep in _gauged_handle_deps - set(handle_depth):
            g.set(0.0, tags={"deployment": dep})
        for dep, n in handle_depth.items():
            g.set(n, tags={"deployment": dep})
        _gauged_handle_deps.update(handle_depth)
    replica_depth: Dict[str, float] = {}
    for r in list(_replicas):
        try:
            replica_depth[r.deployment_name] = \
                replica_depth.get(r.deployment_name, 0.0) \
                + float(r.ongoing_requests())
        except Exception:  # noqa: BLE001 - replica mid-shutdown
            pass
    if replica_depth or _gauged_replica_deps:
        g = get_or_create(
            Gauge, "ray_tpu_serve_replica_queue_depth",
            description="queued + executing serve requests on this "
                        "process's replica (executor default group)",
            tag_keys=("deployment",))
        for dep in _gauged_replica_deps - set(replica_depth):
            g.set(0.0, tags={"deployment": dep})
        for dep, n in replica_depth.items():
            g.set(n, tags={"deployment": dep})
        _gauged_replica_deps.update(replica_depth)
