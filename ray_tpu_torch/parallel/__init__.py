"""ray_tpu_torch.parallel: the port's counterpart of ray_tpu.parallel.

The mesh (a torch.distributed DeviceMesh with the JAX package's axis
names: data, fsdp, pipe, expert, seq and tensor, the size-1 ones among
pipe, expert and seq left out; multi-slice meshes with "dcn"
outermost), the logical sharding rules (DTensor placements) and the
collectives they imply, the training step (single device, data
parallel, or sharded by the rules), ring and Ulysses attention over
`seq`, and the microbatched pipeline over `pipe`. MoE over `expert` is
ops/moe.py.
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
from ray_tpu_torch.parallel.multislice import (  # noqa: F401
    AXIS_DCN,
    MultiSliceConfig,
    dcn_batch_spec,
    make_multislice_mesh,
    validate_multislice_sharding,
)
from ray_tpu_torch.parallel.ring import ring_attention  # noqa: F401
from ray_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401

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
    "ring_attention",
    "ulysses_attention",
    "AXIS_DCN",
    "MultiSliceConfig",
    "make_multislice_mesh",
    "dcn_batch_spec",
    "validate_multislice_sharding",
]
