"""Serve ingress fleet: per-node asyncio proxies + admission control.

reference parity: serve/_private/proxy.py (one asyncio HTTP+gRPC proxy
per node) + proxy_state.py (controller-side fleet lifecycle: start one
proxy per alive node, health-check, drain before removal).

Layout:
  async_bridge.py  ObjectRef -> asyncio.Future bridge (no per-request
                   threads; the core worker's done callback wakes the
                   event loop)
  admission.py     per-deployment inflight/queue limits, token-bucket
                   rate limits, shed decisions (503 + Retry-After /
                   RESOURCE_EXHAUSTED)
  http.py          minimal asyncio HTTP/1.1 server (keep-alive,
                   zero-copy streaming writes for bytes payloads)
  proxy.py         AsyncProxyActor: HTTP + gRPC from one event loop,
                   drain lifecycle, request coalescing into
                   @serve.batch deployments
  fleet.py         ProxyFleetManager: controller-side reconciliation
                   (node join/death, health checks, rolling updates)
"""

from ray_tpu_torch.serve._private.proxy_fleet.admission import (  # noqa: F401
    AdmissionController, ShedDecision)
from ray_tpu_torch.serve._private.proxy_fleet.fleet import (  # noqa: F401
    ProxyFleetManager)
from ray_tpu_torch.serve._private.proxy_fleet.proxy import (  # noqa: F401
    AsyncProxyActor)
