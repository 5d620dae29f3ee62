"""Admission control for the ingress fleet: admit, queue, or shed.

reference parity: the reference proxy's backpressure
(`max_queued_requests`, proxy request-queue limits) + serve's
RESOURCE_EXHAUSTED shedding. Scaled to this runtime: each proxy runs
one AdmissionController on its event loop (single-threaded — no
locks), deciding per request:

  - **capacity**: a deployment admits up to
    `replicas x max_concurrent_queries` in-flight requests plus
    `max_queued_requests` queued beyond capacity (deployment override,
    else `Config.serve_max_queued_per_deployment`). Past that the
    request is shed — a bounded queue browns out; an unbounded one
    collapses (every admitted request times out).
  - **rate**: an optional per-deployment token bucket
    (`rate_limit_rps`, burst = 1s of tokens) sheds the overflow fast
    instead of queueing it into certain timeout.

Shed responses answer immediately: HTTP 503 with `Retry-After`, gRPC
RESOURCE_EXHAUSTED — and count into
`ray_tpu_serve_shed_total{deployment,reason}` (first-class RED, probed
by the `serve_shed_burn` watchdog).

Capacity follows the routing info the proxy's handles already hold
(replica count + max_concurrent_queries pushed by the controller's
long poll), so scaling a deployment up raises its admission ceiling
within one push.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class ShedDecision:
    """Why a request was refused, and when to come back."""

    reason: str          # "capacity" | "rate_limit" | "draining"
    retry_after_s: float
    detail: str


class _TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float):
        self.rate = rate
        self.burst = max(1.0, rate)  # 1s worth of burst
        self.tokens = self.burst
        self.stamp = time.monotonic()

    def try_take(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AdmissionController:
    """Single-threaded (event-loop confined) admission state for one
    proxy. `try_admit` either claims an in-flight slot (caller MUST
    pair it with `release`) or returns a ShedDecision."""

    def __init__(self) -> None:
        self._inflight: Dict[str, int] = {}
        self._buckets: Dict[str, _TokenBucket] = {}
        # routing-derived ceilings, refreshed by the proxy whenever a
        # handle's routing info moves: deployment -> (capacity, queue)
        self._limits: Dict[str, tuple] = {}
        self.shed_total = 0

    # -- limits -------------------------------------------------------

    def update_limits(self, deployment: str, *, replicas: int,
                      max_concurrent_queries: int,
                      max_queued_requests: int,
                      rate_limit_rps: float) -> None:
        from ray_tpu_torch._private.config import Config
        queued = (max_queued_requests if max_queued_requests >= 0
                  else Config.serve_max_queued_per_deployment)
        # an unknown/scaled-to-zero deployment still admits a probe's
        # worth of requests so routing errors surface as 404/500, not
        # a masking 503
        capacity = max(1, replicas) * max(1, max_concurrent_queries)
        self._limits[deployment] = (capacity, queued)
        rate = float(rate_limit_rps or 0.0)
        cur = self._buckets.get(deployment)
        if rate <= 0:
            self._buckets.pop(deployment, None)
        elif cur is None or cur.rate != rate:
            self._buckets[deployment] = _TokenBucket(rate)

    def limits(self, deployment: str) -> tuple:
        from ray_tpu_torch._private.config import Config
        return self._limits.get(
            deployment, (16, Config.serve_max_queued_per_deployment))

    # -- admission ----------------------------------------------------

    def try_admit(self, deployment: str) -> Optional[ShedDecision]:
        """None = admitted (slot claimed); ShedDecision = refused.
        Capacity is checked BEFORE the token bucket: a capacity-shed
        request must not burn a token, or a burst against a full
        deployment drains the bucket while serving nothing and then
        rate-sheds the very requests capacity could take."""
        from ray_tpu_torch._private.config import Config
        retry = Config.serve_shed_retry_after_s
        capacity, queued = self.limits(deployment)
        limit = capacity + queued
        cur = self._inflight.get(deployment, 0)
        if cur >= limit:
            self.shed_total += 1
            return ShedDecision(
                "capacity", retry,
                f"deployment {deployment!r} at admission limit "
                f"({cur} in flight >= {capacity} replica slots + "
                f"{queued} queued)")
        bucket = self._buckets.get(deployment)
        if bucket is not None and not bucket.try_take():
            self.shed_total += 1
            return ShedDecision(
                "rate_limit", retry,
                f"deployment {deployment!r} over its "
                f"{bucket.rate:g} req/s rate limit")
        self._inflight[deployment] = cur + 1
        return None

    def release(self, deployment: str) -> None:
        cur = self._inflight.get(deployment, 1) - 1
        if cur <= 0:
            self._inflight.pop(deployment, None)
        else:
            self._inflight[deployment] = cur

    def inflight(self, deployment: Optional[str] = None) -> int:
        if deployment is not None:
            return self._inflight.get(deployment, 0)
        return sum(self._inflight.values())

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for dep in set(self._inflight) | set(self._limits):
            capacity, queued = self.limits(dep)
            bucket = self._buckets.get(dep)
            out[dep] = {
                "inflight": self._inflight.get(dep, 0),
                "capacity": capacity,
                "max_queued": queued,
                "rate_limit_rps": bucket.rate if bucket else 0.0,
            }
        return out
