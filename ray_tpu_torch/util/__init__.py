"""ray_tpu_torch.util: public utility APIs (placement groups, scheduling
strategies, host-side collectives, state introspection)."""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
from ray_tpu_torch.util.queue import Queue  # noqa: F401
from ray_tpu_torch.util import gpu_profiler  # noqa: F401
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
)

__all__ = [
    "PlacementGroup", "placement_group", "remove_placement_group",
    "get_current_placement_group", "placement_group_table",
    "PlacementGroupSchedulingStrategy", "NodeAffinitySchedulingStrategy",
    "SpreadSchedulingStrategy", "Queue", "ActorPool", "gpu_profiler",
]
