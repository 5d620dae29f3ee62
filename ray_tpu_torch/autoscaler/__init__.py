"""Autoscaler: demand-driven node scale-up/down over a NodeProvider.

reference parity: python/ray/autoscaler/_private/autoscaler.py
(StandardAutoscaler + resource_demand_scheduler bin-packing over a
NodeProvider ABC) and the fake-multinode provider
(autoscaler/_private/fake_multi_node/node_provider.py) used for
provider-free testing — here LocalNodeProvider spawns real node-manager
processes on this machine.
"""

from ray_tpu_torch.autoscaler.autoscaler import (FakeMultiNodeProvider,  # noqa: F401
                                           GKETPUNodeProvider,
                                           LocalNodeProvider,
                                           NodeProvider,
                                           StandardAutoscaler)
from ray_tpu_torch.autoscaler.demand_scheduler import (NodeType,  # noqa: F401
                                                 PlacementGroupDemand,
                                                 get_nodes_to_launch)
from ray_tpu_torch.autoscaler.v2 import (AutoscalerV2,  # noqa: F401
                                   ClusterStatusReader, Instance,
                                   InstanceLifecycleError,
                                   InstanceManager)

__all__ = ["NodeProvider", "LocalNodeProvider", "FakeMultiNodeProvider",
           "GKETPUNodeProvider", "StandardAutoscaler", "NodeType",
           "PlacementGroupDemand", "get_nodes_to_launch",
           "AutoscalerV2", "Instance", "InstanceLifecycleError",
           "InstanceManager", "ClusterStatusReader"]
