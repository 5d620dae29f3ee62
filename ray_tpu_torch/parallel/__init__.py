"""ray_tpu_torch.parallel: the port's counterpart of ray_tpu.parallel.

Ported so far: the mesh (a torch.distributed DeviceMesh with the JAX
package's axis names; the data, fsdp and tensor axes), the logical
sharding rules (DTensor placements), and the training step: single
device, data parallel, or sharded by the rules (FSDP over fsdp, tensor
parallelism over tensor). Ring and Ulysses attention, the pipeline and
the multi-slice helpers come with later slices (ROADMAP.md, Queue 1
item 4).
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_SEQ,
    AXIS_TENSOR,
    MeshConfig,
    get_abstract_mesh,
    make_mesh,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingRules,
    logical_sharding,
    shard_pytree,
    with_logical_constraint,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "get_abstract_mesh",
    "AXIS_DATA",
    "AXIS_FSDP",
    "AXIS_TENSOR",
    "AXIS_SEQ",
    "AXIS_EXPERT",
    "AXIS_PIPE",
    "ShardingRules",
    "logical_sharding",
    "shard_pytree",
    "with_logical_constraint",
]
