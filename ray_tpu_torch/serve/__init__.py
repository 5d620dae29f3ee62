"""ray_tpu_torch.serve: online model serving (Serve equivalent).

reference parity: python/ray/serve — deployments reconciled by a
controller actor (serve/_private/controller.py:87, deployment_state
.py:1149), power-of-two-choices routing (router.py:290,893), per-node
HTTP ingress (proxy.py:122), queue-depth autoscaling
(autoscaling_policy.py). Scaled to this runtime: one controller actor,
replica actors with in-flight accounting, and a per-node asyncio
ingress fleet (serve/_private/proxy_fleet/) with admission control,
load shedding, and drain-safe rolling updates (README "Serve at
scale"). The old threading HTTP proxy survives as a compat shim in
serve/proxy.py.
"""

from ray_tpu_torch.serve.api import (Application, Deployment,  # noqa: F401
                               DeploymentHandle, DeploymentNotFound,
                               delete, deployment, drain_proxy,
                               fleet_status, get_handle, run,
                               shutdown, start_fleet, start_http)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.controller import (get_multiplexed_model_id,  # noqa: F401
                                      multiplexed)
from ray_tpu_torch.serve.grpc_proxy import grpc_call, start_grpc  # noqa: F401

__all__ = [
    "deployment", "Deployment", "Application", "DeploymentHandle",
    "DeploymentNotFound",
    "run", "get_handle", "delete", "shutdown", "start_http",
    "start_grpc", "grpc_call", "batch",
    "start_fleet", "fleet_status", "drain_proxy",
    "multiplexed", "get_multiplexed_model_id",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('serve')
del _rlu
