"""Device mesh over the process group's ranks (counterpart of
ray_tpu/parallel/mesh.py).

The JAX package's mesh is a `jax.sharding.Mesh` over named axes; the
port's is a `torch.distributed` DeviceMesh over the ranks of the default
process group (TorchTrainer starts one), with the same six axis names in
the same order. Only the `data` axis is ported: every other axis must
have size 1, because the sharded train step (FSDP, tensor parallelism)
is a later slice (ROADMAP.md, Queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from ray_tpu_torch._device import DeviceLike, resolve_device

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
AXIS_SEQ = "seq"
AXIS_TENSOR = "tensor"

# Outer-to-inner order, as in the JAX package.
MESH_AXIS_ORDER: Tuple[str, ...] = (
    AXIS_DATA, AXIS_FSDP, AXIS_PIPE, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR,
)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of each parallelism axis. -1 on at most one axis means
    "absorb all remaining devices"."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {
            AXIS_DATA: self.data,
            AXIS_FSDP: self.fsdp,
            AXIS_PIPE: self.pipe,
            AXIS_EXPERT: self.expert,
            AXIS_SEQ: self.seq,
            AXIS_TENSOR: self.tensor,
        }

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Resolve -1 axes against the device count; validate the product."""
        sizes = self.axis_sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed} ({sizes})")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


def check_data_only(sizes: Dict[str, int]) -> None:
    """Raise unless every axis but `data` has size 1."""
    other = {a: s for a, s in sizes.items() if a != AXIS_DATA and s != 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: the sharded train step (FSDP, tensor, "
            f"sequence, expert and pipeline axes) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 2); only the data axis is")


def make_mesh(config: Optional[MeshConfig] = None, *,
              device: DeviceLike = None):
    """A DeviceMesh with the standard axis names over every rank of the
    default process group, in order. Its device type is CUDA unless the
    caller names another (``device="cpu"`` over a gloo group), and CUDA
    raises without a card."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    config = config or MeshConfig()
    check_data_only(config.axis_sizes())
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group; "
            "TorchTrainer's workers have one")
    world = dist.get_world_size()
    sizes = config.resolve(world)
    shape = tuple(sizes[a] for a in MESH_AXIS_ORDER)
    return DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=MESH_AXIS_ORDER)
