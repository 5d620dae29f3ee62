"""Device mesh over the process group's ranks (counterpart of
ray_tpu/parallel/mesh.py).

The JAX package's mesh is a `jax.sharding.Mesh` over six named axes;
the port's is a `torch.distributed` DeviceMesh over the ranks of the
default process group (TorchTrainer starts one) with the axes it runs:
`data`, `fsdp` and `tensor`, in the JAX order (PORTED_AXES). The `seq`,
`pipe` and `expert` axes must have size 1 until ring and Ulysses
attention, the pipeline and MoE are ported (ROADMAP.md, Queue 1 item
4), and leaving those size-1 axes out places every rank where the JAX
mesh does. It also keeps DTensor's sharding propagation cheap: it
enumerates strategies over every mesh dim, and one pointwise op on a
six-dim mesh took over 25 s on the CPU where three dims take 0.2 s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

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


# the axes whose parallelism the port runs; the others must have size 1
PORTED_AXES: Tuple[str, ...] = (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR)


def check_ported_axes(sizes: Mapping[str, int]) -> None:
    """Raise unless every axis the port does not run yet has size 1."""
    other = {a: s for a, s in sizes.items()
             if a not in PORTED_AXES and s != 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: sequence, pipeline and expert parallelism "
            f"are not ported yet (ROADMAP.md, Queue 1 item 4); the data, "
            f"fsdp and tensor axes are")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes with no devices and no process group
    (counterpart of jax.sharding.AbstractMesh): what the sharding rules
    read, so they resolve without a process group."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def get_abstract_mesh(config: MeshConfig, n_devices: int) -> AbstractMesh:
    """The mesh `make_mesh(config)` would build over `n_devices` ranks,
    shape only."""
    check_ported_axes(config.axis_sizes())
    sizes = config.resolve(n_devices)
    return AbstractMesh(PORTED_AXES, tuple(sizes[a] for a in PORTED_AXES))


def mesh_shape(mesh) -> Dict[str, int]:
    """axis name -> size of a DeviceMesh from make_mesh or an
    AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_mesh(config: Optional[MeshConfig] = None, *,
              device: DeviceLike = None):
    """A DeviceMesh over every rank of the default process group with the
    axes PORTED_AXES, sized by `config`. Its device type is CUDA unless the
    caller names another (``device="cpu"`` over a gloo group), and CUDA
    raises without a card. The seq, pipe and expert axes raise above
    size 1 (Queue 1 item 4)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    config = config or MeshConfig()
    check_ported_axes(config.axis_sizes())
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group; "
            "TorchTrainer's workers have one")
    world = dist.get_world_size()
    sizes = config.resolve(world)
    shape = tuple(sizes[a] for a in PORTED_AXES)
    return DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=PORTED_AXES)
