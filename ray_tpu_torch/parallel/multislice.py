"""Multi-slice meshes (counterpart of ray_tpu/parallel/multislice.py):
a fast link within a slice, a slow one across slices.

On TPU pods the hierarchy is ICI within a slice and DCN across slices;
on GPUs it is NVLink within a node and the network across nodes. The
mesh encodes it the same way: an outermost "dcn" axis of size
num_slices, over which only data-parallel traffic (the once-a-step grad
reduction) may run; every model axis (fsdp, tensor, seq, ...) stays
inside a slice. A slice is the ranks of one node, grouped by the
runtime's node id where the ranks span nodes; on one node, contiguous
equal partitions of the ranks stand in for slices (the JAX module's CPU
rule), and the collectives are the same.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.mesh import MeshConfig, mesh_axis_names

AXIS_DCN = "dcn"

# axes allowed to span the DCN boundary (outer, once-per-step traffic)
DCN_SPANNABLE = ("data",)


@dataclasses.dataclass(frozen=True)
class MultiSliceConfig:
    """num_slices data-parallel replicas of a per-slice MeshConfig.

    The mesh has an extra outermost "dcn" axis of size num_slices;
    shardings over the standard axes are unchanged (dcn is an extra data
    axis: the batch shards over ("dcn", "data"))."""

    num_slices: int
    per_slice: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def resolve(self, n_devices: int) -> Dict[str, int]:
        if self.num_slices <= 0:
            raise ValueError(f"num_slices must be >= 1, "
                             f"got {self.num_slices}")
        if n_devices % self.num_slices != 0:
            raise ValueError(
                f"{n_devices} devices not divisible into "
                f"{self.num_slices} slices")
        per = self.per_slice.resolve(n_devices // self.num_slices)
        return {AXIS_DCN: self.num_slices, **per}


def slice_ranks(node_ids: Sequence[str], num_slices: int) -> List[List[int]]:
    """The ranks of each slice, in slice order: grouped by node id (in
    order of each node's first rank) where the ranks span nodes, else
    contiguous equal partitions. Raises unless the slices are
    num_slices of equal size."""
    n = len(node_ids)
    if num_slices <= 0 or n % num_slices:
        raise ValueError(f"{n} ranks not divisible into {num_slices} slices")
    if len(set(node_ids)) > 1:
        by_node: Dict[str, List[int]] = {}
        for rank, node in enumerate(node_ids):
            by_node.setdefault(node, []).append(rank)
        slices = list(by_node.values())
    else:
        per = n // num_slices
        slices = [list(range(s * per, (s + 1) * per))
                  for s in range(num_slices)]
    if len(slices) != num_slices or len({len(s) for s in slices}) != 1:
        raise ValueError(f"ranks do not form {num_slices} equal slices: "
                         f"{[len(s) for s in slices]}")
    return slices


def _node_id() -> str:
    """This process's node: the runtime's node id where it runs in one,
    else the host's name."""
    from ray_tpu_torch import api
    if api.is_initialized():
        return api.get_runtime_context().get_node_id()
    import socket
    return socket.gethostname()


def make_multislice_mesh(config: MultiSliceConfig, *,
                         node_ids: Optional[Sequence[str]] = None,
                         device: DeviceLike = None):
    """A DeviceMesh over every rank of the default process group with
    axes ("dcn", "data", "fsdp", ..., "tensor"): dcn outermost, so only
    replica-gradient reductions cross slices; within a slice the axes of
    make_mesh. `node_ids` (one per rank) says which node each rank is on;
    by default every rank's own is all-gathered. CUDA unless `device`
    names another."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_multislice_mesh needs a torch.distributed "
                           "process group")
    world = dist.get_world_size()
    sizes = config.resolve(world)
    if node_ids is None:
        node_ids = [None] * world
        dist.all_gather_object(node_ids, _node_id())
    names = mesh_axis_names(sizes)
    shape = tuple(sizes[a] for a in names)
    ranks = torch.tensor(slice_ranks(node_ids, config.num_slices))
    return DeviceMesh(dev.type, ranks.reshape((config.num_slices,) + shape),
                      mesh_dim_names=(AXIS_DCN,) + names)


def dcn_batch_spec(*trailing):
    """The spec sharding the batch over both the cross-slice and in-slice
    data axes: (("dcn", "data"), *trailing) (spec_placements turns it
    into DTensor placements)."""
    return ((AXIS_DCN, "data"),) + tuple(trailing)


def validate_multislice_sharding(spec, *, strict: bool = True) -> None:
    """Reject a spec (a tuple of mesh-axis entries) that puts a model axis
    on DCN beside "dcn" (a tensor-parallel all-reduce across slices is a
    slowdown, not an error: nothing else would stop it)."""
    if not isinstance(spec, tuple):
        return
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        if AXIS_DCN in axes:
            partnered = [a for a in axes if a != AXIS_DCN]
            bad = [a for a in partnered if a not in DCN_SPANNABLE]
            if partnered and bad:
                msg = (f"spec dim {i} shards {bad} together with "
                       f"'{AXIS_DCN}': only {DCN_SPANNABLE} may span the "
                       f"cross-slice (DCN) boundary")
                if strict:
                    raise ValueError(msg)
                logging.getLogger(__name__).warning(msg)


def per_slice_process_groups(num_slices: int, hosts_per_slice: int
                             ) -> Dict[int, range]:
    """Rank ranges per slice for a multi-slice job: slice s owns ranks
    [s*h, (s+1)*h), and rank 0 of slice 0 hosts the rendezvous (the
    MASTER_ADDR role)."""
    if num_slices <= 0 or hosts_per_slice <= 0:
        raise ValueError("num_slices and hosts_per_slice must be >= 1")
    return {s: range(s * hosts_per_slice, (s + 1) * hosts_per_slice)
            for s in range(num_slices)}
