"""ray_tpu_torch.parallel: the port's counterpart of ray_tpu.parallel.

Ported so far: the mesh (a torch.distributed DeviceMesh with the JAX
package's axis names, data axis only) and the training step, single
device or data parallel. Sharding rules, FSDP, tensor parallelism, ring
and Ulysses attention and the multi-slice helpers come with later slices
(ROADMAP.md).
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_SEQ,
    AXIS_TENSOR,
    MeshConfig,
    make_mesh,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "AXIS_DATA",
    "AXIS_FSDP",
    "AXIS_TENSOR",
    "AXIS_SEQ",
    "AXIS_EXPERT",
    "AXIS_PIPE",
]
