"""Logical-axis sharding rules (counterpart of ray_tpu/parallel/sharding.py).

Arrays carry *logical* axis names ("batch", "embed", "heads", ...) and a
`ShardingRules` table maps each logical name to a mesh axis (or a tuple
of them, or None = replicated), with the JAX package's table. In JAX the
result is a NamedSharding and XLA inserts the collectives. Here it is
one DTensor placement per mesh dimension: `Shard(d)` on each mesh axis
behind tensor dim d, `Replicate()` elsewhere. A dim split over a tuple of
axes ("batch" -> ("data", "fsdp")) is `Shard(d)` on each of them, the
first axis major, as in JAX. Resolution is a pure function of the mesh's
axis sizes (a DeviceMesh or a shape-only `AbstractMesh`), so it needs no
process group.

The collectives the rules imply are explicit: `gather_at_use` casts a
param shard to the compute dtype and all-gathers it when a layer runs,
and reduce-scatters its grad back to the shard; `to_parallel` and
`sum_over` are Megatron's f and g over any axes (the column- and
row-parallel projections over `tensor`, the experts over `expert`);
`ppermute` and `all_to_all` are JAX's `lax.ppermute` and tiled
`lax.all_to_all` over one axis (the pipeline's hand-off, Ulysses'
resharding), each an autograd Function whose backward is the inverse
exchange. Every rank of an axis must make the same exchanges in the
same order, forward and backward, or the collectives hang.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_FSDP,
                                         AXIS_PIPE, AXIS_SEQ, AXIS_TENSOR,
                                         mesh_shape)

# A logical spec is a tuple of logical axis names (or None) per array dim.
LogicalSpec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (str | tuple of str | None).

    The default table implements, in one place:
      - DP:    "batch"  -> ("data", "fsdp")  (batch split over both)
      - FSDP:  "embed"  -> "fsdp"            (params reduce-scattered, ZeRO-3)
      - TP:    "heads"/"mlp"/"vocab" -> "tensor" (Megatron-style column/row)
      - SP:    "seq"    -> "seq"             (context parallelism / ring)
      - EP:    "expert" -> "expert"
      - PP:    "layers" -> "pipe"            (stage-stacked scan)
    """

    rules: Dict[str, Union[str, Tuple[str, ...], None]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical not in self.rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.rules[logical]

    def spec(self, logical_spec: LogicalSpec) -> Tuple:
        """The mesh-axis entries (str | tuple | None) of a tuple of logical
        names: a jax PartitionSpec's entries."""
        return tuple(self.mesh_axes(name) for name in logical_spec)

    def replace(self, **updates) -> "ShardingRules":
        new = dict(self.rules)
        new.update(updates)
        return ShardingRules(rules=new)


DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": (AXIS_DATA, AXIS_FSDP),
    "seq": AXIS_SEQ,
    "embed": AXIS_FSDP,
    "heads": AXIS_TENSOR,
    "kv_heads": AXIS_TENSOR,
    "head_dim": None,
    "mlp": AXIS_TENSOR,
    "vocab": AXIS_TENSOR,
    "layers": AXIS_PIPE,
    "expert": AXIS_EXPERT,
    "norm": None,
    # Activation axes (distinct from param axes: activations keep their
    # feature dims replicated/tensor-sharded even when params are
    # fsdp-sharded — that's what makes it FSDP rather than naive TP).
    "act_embed": None,
    "act_mlp": AXIS_TENSOR,
    "act_vocab": AXIS_TENSOR,
}


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_entry_size(entry, mesh) -> int:
    """Product of mesh-axis sizes behind one spec entry (str | tuple |
    None) — the shard count of that dimension."""
    shape = mesh_shape(mesh)
    return math.prod(shape.get(a, 1) for a in _axes(entry))


def fit_spec_to_shape(spec, shape, mesh) -> Tuple:
    """Degrade spec entries whose shard count doesn't divide the dimension
    to replicated (the single source of the divisibility rule: param and
    optimizer placements, and the attention's GQA widening)."""
    cleaned = []
    for d, entry in enumerate(spec):
        if entry is not None and shape is not None and d < len(shape):
            size = spec_entry_size(entry, mesh)
            if size and shape[d] % size != 0:
                entry = None
        cleaned.append(entry)
    return tuple(cleaned)


def logical_spec(logical: LogicalSpec, mesh,
                 rules: Optional[ShardingRules] = None,
                 shape: Optional[Tuple[int, ...]] = None) -> Tuple:
    """The mesh-axis spec of one array given its logical spec: the
    entries of the jax NamedSharding that `logical_sharding` builds in
    the JAX package. Mesh axes of size 1 are dropped (they are replicated
    anyway, and it keeps specs valid on a one-card mesh); with `shape`,
    entries whose shard count does not divide the dim become replicated
    (e.g. 2 kv heads over a 4-wide tensor axis)."""
    rules = rules or ShardingRules()
    sizes = mesh_shape(mesh)
    cleaned = []
    for entry in rules.spec(logical):
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if sizes.get(a, 1) > 1)
            cleaned.append(kept if kept else None)
        elif entry is not None and sizes.get(entry, 1) <= 1:
            cleaned.append(None)
        else:
            cleaned.append(entry)
    return fit_spec_to_shape(cleaned, shape, mesh)


def spec_placements(spec, mesh) -> Tuple:
    """One DTensor placement per mesh dim for a mesh-axis spec (size-1
    axes off the mesh already dropped): Shard(d) on each axis behind dim
    d, else Replicate. A dim over a tuple of axes takes them major to
    minor, which DTensor reads in mesh order, so the tuple must follow
    it."""
    names = tuple(mesh_shape(mesh))
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"dim {d} is split over {axes}, out of the "
                             f"mesh's order {names}")
        for a in axes:
            m = names.index(a)
            if placements[m] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"spec {spec}")
            placements[m] = Shard(d)
    return tuple(placements)


def logical_sharding(logical: LogicalSpec, mesh,
                     rules: Optional[ShardingRules] = None,
                     shape: Optional[Tuple[int, ...]] = None) -> Tuple:
    """DTensor placements for one array given its logical spec (the
    counterpart of the JAX NamedSharding): `logical_spec`, then
    `spec_placements`."""
    return spec_placements(logical_spec(logical, mesh, rules, shape), mesh)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, str) or e is None for e in x)


def shard_pytree(spec_tree: Any, mesh,
                 rules: Optional[ShardingRules] = None):
    """Map a nested dict of logical specs to the same structure of
    placements (no shapes: nothing is degraded for divisibility)."""
    if _is_spec(spec_tree):
        return logical_sharding(spec_tree, mesh, rules)
    return {k: shard_pytree(v, mesh, rules) for k, v in spec_tree.items()}


def flatten_specs(spec_tree: Dict[str, Any],
                  prefix: str = "") -> Dict[str, LogicalSpec]:
    """A nested dict of logical specs keyed by dotted names, as
    nn.Module.named_parameters names them ("layers.wqkv")."""
    out = {}
    for k, v in spec_tree.items():
        if _is_spec(v):
            out[prefix + k] = v
        else:
            out.update(flatten_specs(v, f"{prefix}{k}."))
    return out


def with_logical_constraint(x: Any, logical: LogicalSpec, mesh=None,
                            rules: Optional[ShardingRules] = None):
    """Redistribute a DTensor to the placements of its logical spec; a
    no-op on plain tensors and with no mesh (as the JAX one is outside
    jit), so model code runs unsharded. Typo'd names raise KeyError."""
    rules = rules or ShardingRules()
    rules.spec(logical)
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, logical_sharding(logical, mesh, rules,
                                                 shape=tuple(x.shape)))


def local_slices(shape: Tuple[int, ...], placements,
                 mesh) -> Tuple[slice, ...]:
    """This rank's slice of a tensor of `shape` placed by `placements` on
    `mesh` (a DeviceMesh: its coordinate), the shards even."""
    sizes = list(mesh_shape(mesh).values())
    coord = mesh.get_coordinate()
    index, count = [0] * len(shape), [1] * len(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            index[pl.dim] = index[pl.dim] * sizes[m] + coord[m]
            count[pl.dim] *= sizes[m]
    out = []
    for n, i, c in zip(shape, index, count):
        if n % c:
            raise ValueError(f"shape {tuple(shape)} does not split evenly "
                             f"by {tuple(placements)}")
        out.append(slice(i * (n // c), (i + 1) * (n // c)))
    return tuple(out)


def place(full: torch.Tensor, mesh, placements) -> DTensor:
    """A DTensor of `full`'s global shape on `mesh` holding only this
    rank's slice (every rank passes the same `full`; no collective)."""
    local = full[local_slices(tuple(full.shape), placements, mesh)]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False)


# ---- the collectives the rules imply -----------------------------------

def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


# all_gather_single and reduce_scatter_single are the newer names of
# all_gather_tensor and reduce_scatter_tensor (the old ones warn there)
_GATHER = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
_SCATTER = getattr(funcol, "reduce_scatter_single",
                   funcol.reduce_scatter_tensor)


def _all_gather(x, dim, group):
    return _wait(_GATHER(x.contiguous(), dim, group))


def _reduce_scatter(x, dim, group):
    return _wait(_SCATTER(x.contiguous(), "sum", dim, group))


def _all_reduce(x, group):
    return _wait(funcol.all_reduce(x.contiguous(), "sum", group))


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a DeviceMesh as this rank sees it."""

    name: str
    size: int
    coord: int
    group: Any   # its process group; None at size 1


def mesh_axes(mesh) -> Tuple[MeshAxis, ...]:
    """Every axis of a DeviceMesh from make_mesh, in mesh order; a group
    only for the axes above size 1."""
    coord = mesh.get_coordinate()
    return tuple(MeshAxis(n, s, c, mesh.get_group(n) if s > 1 else None)
                 for n, s, c in zip(mesh.mesh_dim_names, mesh.shape, coord))


def mesh_axis(mesh, name: str) -> MeshAxis:
    """Axis `name` of a DeviceMesh (or None) as this rank sees it; an
    axis the mesh leaves out has size 1."""
    if mesh is not None and name in (mesh.mesh_dim_names or ()):
        return next(a for a in mesh_axes(mesh) if a.name == name)
    return MeshAxis(name, 1, 0, None)


class _GatherAtUse(torch.autograd.Function):
    """Forward: cast a shard to `dtype`, then all-gather it over each
    gathered axis, inner axes first. Backward: the grad back in the
    shard's dtype, then over each axis in mesh order a reduce-scatter
    (gathered, grad partial), a slice of this rank's chunk (gathered,
    grad the same on every rank) or an all-reduce (replicated, grad
    partial)."""

    @staticmethod
    def forward(ctx, shard, dtype, gathers, reduces):
        ctx.shard_dtype, ctx.reduces = shard.dtype, reduces
        x = shard.to(dtype)
        for dim, axis in reversed(gathers):
            x = _all_gather(x, dim, axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.shard_dtype)
        for op, dim, axis in ctx.reduces:
            if op == "reduce_scatter":
                g = _reduce_scatter(g, dim, axis.group)
            elif op == "slice":
                g = g.chunk(axis.size, dim)[axis.coord]
            else:
                g = _all_reduce(g, axis.group)
        return g, None, None, None


def gather_at_use(shard: torch.Tensor, dtype: torch.dtype, placements,
                  axes: Tuple[MeshAxis, ...], gather: Iterable[str] = (),
                  partial: Iterable[str] = (), dim_offset: int = 0):
    """A param's shard (plain: a DTensor's local tensor, or a slice of it
    along its first `dim_offset` dims) as the compute needs it: cast to
    `dtype` and all-gathered over the mesh axes `gather` where the param
    is sharded. Its grad goes back to the shard: reduce-scattered over
    the gathered axes in `partial` (each rank's grad a partial sum: the
    axes the batch is split over), sliced over the others, and
    all-reduced over the axes in `partial` where the param is replicated.
    With nothing to move it is a cast, as on one card."""
    gather, partial = set(gather), set(partial)
    gathers, reduces = [], []
    for axis, pl in zip(axes, placements):
        if axis.size == 1:
            continue
        if isinstance(pl, Shard):
            dim = pl.dim - dim_offset
            if axis.name in gather:
                gathers.append((dim, axis))
                reduces.append(("reduce_scatter" if axis.name in partial
                                else "slice", dim, axis))
            elif axis.name in partial:
                raise ValueError(f"a grad partial over {axis.name!r} needs "
                                 f"the param gathered over it")
        elif axis.name in partial:
            reduces.append(("all_reduce", None, axis))
    if not (gathers or reduces):
        return shard.to(dtype)
    return _GatherAtUse.apply(shard, dtype, tuple(gathers), tuple(reduces))


def _groups(axes) -> Tuple[Any, ...]:
    if isinstance(axes, MeshAxis):
        axes = (axes,)
    return tuple(a.group for a in axes if a.size > 1)


def _all_reduce_each(x, groups):
    for g in groups:
        x = _all_reduce(x, g)
    return x


class _ToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_each(g, ctx.groups), None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce_each(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce_each(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_each(g, ctx.groups), None


def to_parallel(x: torch.Tensor, axes) -> torch.Tensor:
    """Megatron's f over `axes` (a MeshAxis or several): the input of a
    block split over them (column-parallel projections over `tensor`,
    the experts over `expert`), the same on every rank; its grad (each
    rank's from its own part) is summed over the axes."""
    groups = _groups(axes)
    return _ToParallel.apply(x, groups) if groups else x


def sum_over(x: torch.Tensor, axes) -> torch.Tensor:
    """Megatron's g over `axes`: the ranks' partial outputs summed (a
    row-parallel projection, each rank's experts, the pipeline's stage
    losses); the grad passes through unchanged, the sum being the same
    on every rank."""
    groups = _groups(axes)
    return _SumOver.apply(x, groups) if groups else x


def sum_across(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over `axes` of partial values whose every rank's use is a
    share of one objective (e.g. MoE router probs summed over the token
    shards): all-reduce forward, all-reduce of the grads backward."""
    groups = _groups(axes)
    return _SumAcross.apply(x, groups) if groups else x


def all_gather_dim(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """x of every rank of `axis`, concatenated along `dim` in rank order
    (no grad)."""
    if axis.size == 1:
        return x
    return _all_gather(x, dim, axis.group)


def _exchange(tensors, axis: MeshAxis, shift: int):
    """Send each of `tensors` to the rank `shift` places on along `axis`
    and return what the rank `shift` places back sent, in one
    batch_isend_irecv (on a ring of 2 both peers are the same rank)."""
    import torch.distributed as dist
    group = axis.group
    to = dist.get_global_rank(group, (axis.coord + shift) % axis.size)
    frm = dist.get_global_rank(group, (axis.coord - shift) % axis.size)
    ops, out = [], []
    for t in tensors:
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, to, group),
                dist.P2POp(dist.irecv, buf, frm, group)]
        out.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def exchange(tensors, axis: MeshAxis, shift: int = 1):
    """`_exchange` with no autograd (the ring's K/V and dK/dV hops); the
    identity at axis size 1."""
    if axis.size == 1:
        return list(tensors)
    return _exchange(tensors, axis, shift)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _exchange([x], axis, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return _exchange([g], ctx.axis, -ctx.shift)[0], None, None


def ppermute(x: torch.Tensor, axis: MeshAxis, shift: int = 1) -> torch.Tensor:
    """lax.ppermute over a ring: rank i's x goes to rank (i + shift) mod
    n of `axis`; its backward sends the grad the opposite way. The
    identity at axis size 1."""
    if axis.size == 1:
        return x
    return _Ppermute.apply(x, axis, shift)


def _a2a(x, axis: MeshAxis, split_dim: int, concat_dim: int):
    import torch.distributed as dist
    inp = torch.stack(x.chunk(axis.size, split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=axis.group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = axis, split_dim, concat_dim
        return _a2a(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _a2a(g, axis, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, axis: MeshAxis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """lax.all_to_all(tiled=True) over `axis`: x splits into n equal
    chunks along split_dim, chunk j goes to rank j, and the chunks each
    rank receives are concatenated along concat_dim in rank order (one
    all_to_all_single); its backward is the inverse all-to-all. The
    identity at axis size 1."""
    if axis.size == 1:
        return x
    if x.shape[split_dim] % axis.size:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {axis.size} ranks of {axis.name!r}")
    return _AllToAll.apply(x, axis, split_dim, concat_dim)
