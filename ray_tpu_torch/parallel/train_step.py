"""Training-step factory (counterpart of ray_tpu/parallel/train_step.py).

The step: loss, backward, the global gradient norm, and an AdamW update
equal to optax.adamw. The JAX step is one jitted function with sharded
state; here PyTorch runs eagerly and updates the params in place (so
``state["params"]`` holds the live tensors the loss reads).

Every rank passes the global batch, and the step is the one the JAX
package computes on the whole of it. The batch splits over the data
axis (and "dcn" on a multi-slice mesh), or with param_specs over the
rules' "batch" axes (data and fsdp): the rank at position r of D such
ranks takes rows [r B/D, (r+1) B/D), and ranks that differ only in
their tensor, pipe or expert coordinate take the same rows. Over a
`seq` axis of size S each row's inputs and targets, after the
next-token shift, split into S contiguous column blocks, the rank at
seq position s taking block s (as {"tokens", "targets"}). The loss is
a mean, as Transformer.loss's is: over the batch's "mask" where it
holds one, else over its tokens. So each rank weighs its loss and grads
by its share of the global denominator (its mask sum over the global
one, which every rank reads from the global batch; its tokens over all
of them unmasked), and the sum over the ranks (data x fsdp x seq) is the
global loss and grad even where the ranks' masks differ.

- mesh=None: the single-device step.
- A data mesh, param_specs None: every param replicated; one all-reduce
  sums the weighed grads and the loss, before the norm and the update.
  At D = 1 there is no collective, as XLA emits none.
- param_specs on a mesh (any axes of make_mesh): init_state places each
  param as a DTensor by the logical rules (parallel/sharding.py), and
  the optimizer's moments, created like their params, take the same
  placements (torch.optim keys its state by the param, so a moment is
  matched to its param, never by shape). The loss's backward weighs by
  the share; the model's gathers reduce-scatter each grad to its
  param's placements, so the grad norm is one all-reduce of the shards'
  squares.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_SEQ,
                                         mesh_axis_names, mesh_shape)
from ray_tpu_torch.parallel.sharding import (ShardingRules, flatten_specs,
                                             logical_sharding, place)
from ray_tpu_torch.util import cuda_sentinel

OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


# optax.adamw's defaults, which no caller of the port changes
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def adamw(learning_rate: float, weight_decay: float = 1e-4) -> OptimizerFactory:
    """optax.adamw with mask=None, as a factory of torch.optim.AdamW.

    Both take eps outside the square root, bias-correct both moments and
    decay every param by lr * weight_decay * p (decoupled), so the update
    is the same. optax's own default decay is 1e-4: pass it explicitly.
    The fused implementation runs the update as one op over every param:
    over DTensors the foreach path's first step spends seconds in
    sharding propagation per mesh dim (one TINY step: 1.3 s on a 3-dim
    mesh, 9.7 s on 4 dims; fused 0.7 s on 4 dims, CPU)."""
    def make(params):
        return torch.optim.AdamW(params, lr=learning_rate, betas=(_B1, _B2),
                                 eps=_EPS, weight_decay=weight_decay,
                                 fused=True)
    return make


def make_train_step(
        loss_fn: Callable[[Dict[str, torch.Tensor], Dict[str, Any]], Any],
        param_specs: Any = None,
        mesh=None,
        *,
        optimizer: Optional[OptimizerFactory] = None,
        rules: Optional[ShardingRules] = None,
        device: DeviceLike = None,
) -> Tuple[Callable, Callable]:
    """Build (init_state, train_step).

    loss_fn(params, batch) -> scalar loss (or (loss, aux dict)) of this
    rank's rows, where params is the name -> tensor dict of the state
    (e.g. ``lambda p, b: model.loss(b, mesh=mesh)``).
    init_state(params) -> state dict, params being a module or its
    ``dict(module.named_parameters())``; train_step(state, batch) ->
    (state, {"loss", "grad_norm", "step"}).

    With param_specs (a nested dict of logical specs whose dotted names
    are the params', e.g. Transformer.param_specs(cfg)) on a mesh,
    init_state places each param by `rules`: given the module, it puts
    plain params on the mesh and into the module; given a dict, the
    params must be placed already (params_from_jax(mesh=...)). A mesh
    with an fsdp or tensor axis needs param_specs.
    """
    dev = resolve_device(device)
    if optimizer is None:
        optimizer = adamw(3e-4, weight_decay=0.01)
    if mesh is not None:
        _check_mesh(mesh, dev)
    if param_specs is not None and mesh is not None:
        return _sharded_step(loss_fn, flatten_specs(param_specs), mesh,
                             rules or ShardingRules(), optimizer, dev)
    if mesh is None:
        groups, rank, size = [], 0, 1
    else:
        other = {a: s for a, s in mesh_shape(mesh).items()
                 if a not in _DATA_AXES and s != 1}
        if other:
            raise ValueError(f"mesh axes {other} shard the params: pass "
                             f"param_specs")
        groups, rank, size = _split(mesh, _DATA_AXES)

    def init_state(params) -> Dict[str, Any]:
        params = _named(params)
        for name, p in params.items():
            _check_device(name, p, dev)
        return {"params": params,
                "opt_state": optimizer(list(params.values())),
                "step": 0}

    def train_step(state, batch):
        params = state["params"]
        if size > 1:
            batch, share = _rows_and_share(batch, rank, size)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for p in params.values():
            p.grad = None
        out = loss_fn(params, batch)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        loss.backward()
        grads = _grads(params)
        if size > 1:
            loss = _all_reduce_weighted(grads, loss.detach(), share, groups)
        # global L2 norm over every grad, before the update
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
        return _update(state, loss, gnorm, aux)

    return init_state, _in_region(train_step)


# the axes a data-parallel (param_specs None) step splits the batch over
_DATA_AXES = ("dcn", AXIS_DATA)


def _split(mesh, axes):
    """(the groups of `axes` above size 1, this rank's position among the
    row blocks they make, first axis major, and their count)."""
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    rank, size = 0, 1
    for a in axes:
        n = sizes.get(a, 1)
        rank, size = rank * n + coord.get(a, 0), size * n
    return [mesh.get_group(a) for a in axes if sizes.get(a, 1) > 1], \
        rank, size


def _sharded_step(loss_fn, specs, mesh, rules, optimizer, dev):
    """(init_state, train_step) with the params placed on the mesh."""
    sizes = mesh_shape(mesh)
    batch = rules.mesh_axes("batch")
    batch = tuple(batch) if isinstance(batch, tuple) else (batch,)
    groups, rank, size = _split(mesh, batch)
    seq_groups, seq_rank, seq_size = _split(mesh, (AXIS_SEQ,))
    groups += seq_groups
    world = math.prod(sizes.values())

    def init_state(params) -> Dict[str, Any]:
        module = params if isinstance(params, nn.Module) else None
        params = _named(params)
        if set(params) != set(specs):
            raise ValueError(f"params {sorted(params)} and param_specs "
                             f"{sorted(specs)} differ")
        placed = {}
        for name, p in params.items():
            _check_device(name, p, dev)
            placements = logical_sharding(specs[name], mesh, rules,
                                          shape=tuple(p.shape))
            if isinstance(p, DTensor):
                if p.device_mesh != mesh or tuple(p.placements) != placements:
                    raise ValueError(
                        f"param {name} is placed {tuple(p.placements)} on "
                        f"{p.device_mesh}; the rules give {placements} on "
                        f"{mesh}")
                placed[name] = p
            elif module is None:
                raise ValueError(
                    f"param {name} is not on the mesh: pass the module to "
                    f"init_state, or place the params first")
            else:
                placed[name] = nn.Parameter(
                    place(p.detach(), mesh, placements),
                    requires_grad=p.requires_grad)
        if module is not None:
            module.load_state_dict(placed, assign=True)
            placed = dict(module.named_parameters())
        return {"params": placed,
                "opt_state": optimizer(list(placed.values())),
                "step": 0}

    def train_step(state, global_batch):
        params = state["params"]
        local, share = _rows_and_share(global_batch, rank, size, seq_rank,
                                       seq_size)
        local = {k: torch.as_tensor(v, device=dev) for k, v in local.items()}
        for p in params.values():
            p.grad = None
        out = loss_fn(params, local)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        (loss * share if groups else loss).backward()
        grads = _grads(params)
        loss = loss.detach() * share
        for g in groups:
            dist.all_reduce(loss, group=g)
        # each shard's squares once: a shard held by r ranks counts 1/r
        # from each of them
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in zip(params.values(), grads):
            if tuple(g.placements) != tuple(p.placements):
                raise RuntimeError(f"a grad placed {g.placements} for a "
                                   f"param placed {p.placements}")
            copies = math.prod(n for n, pl in zip(sizes.values(),
                                                  g.placements)
                               if not pl.is_shard())
            sq += torch.linalg.vector_norm(
                g.to_local(), dtype=torch.float32) ** 2 / copies
        if world > 1:
            dist.all_reduce(sq)
        return _update(state, loss, torch.sqrt(sq), aux)

    return init_state, _in_region(train_step)


def _in_region(step):
    """The step inside the sentinel's "train.step" region, as the JAX
    package runs its jitted step (util/cuda_sentinel.py)."""
    @functools.wraps(step)
    def train_step(state, batch):
        with cuda_sentinel.step_region("train.step"):
            return step(state, batch)
    return train_step


def _update(state, loss, gnorm, aux):
    state["opt_state"].step()
    step = state["step"] + 1
    new_state = {"params": state["params"], "opt_state": state["opt_state"],
                 "step": step}
    metrics = {"loss": loss.detach(), "grad_norm": gnorm, "step": step,
               **aux}
    return new_state, metrics


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _check_device(name, p, dev):
    if p.device.type != dev.type or (
            dev.index is not None and p.device.index != dev.index):
        raise ValueError(f"param {name} is on {p.device}, the step runs on "
                         f"{dev}")


def _grads(params):
    grads = []
    for p in params.values():
        if p.grad is None:  # unused param: a zero grad, as jax.grad gives
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    return grads


def _check_mesh(mesh, dev: torch.device):
    """Raise for a mesh the step cannot run on."""
    names = tuple(mesh.mesh_dim_names or ())
    inner = names[1:] if names[:1] == ("dcn",) else names
    if inner != mesh_axis_names(mesh_shape(mesh)):
        raise ValueError(f"a mesh from parallel.make_mesh (or "
                         f"make_multislice_mesh) is needed, got axes {names}")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is over {mesh.device_type} and the "
                         f"step runs on {dev}")


def _rows_and_share(batch: Dict[str, Any], rank: int, size: int,
                    seq_rank: int = 0, seq_size: int = 1):
    """(rank `rank`'s rows of the global batch, [r B/D, (r+1) B/D), and
    over a seq axis its column block `seq_rank` of the shifted inputs and
    targets; their share of the global loss denominator)."""
    total = _loss_denominator(batch)
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"batch entries differ in rows: {sorted(rows)}")
    (b,) = rows
    if b % size:
        raise ValueError(f"a global batch of {b} rows does not split over "
                         f"{size} ranks")
    n = b // size
    local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    if seq_size > 1:
        if "targets" not in local:
            full = local.pop("tokens")
            local["tokens"], local["targets"] = full[:, :-1], full[:, 1:]
        t = local["targets"].shape[1]
        if t % seq_size:
            raise ValueError(f"{t} target columns do not split over "
                             f"{seq_size} seq ranks")
        cols = slice(seq_rank * (t // seq_size),
                     (seq_rank + 1) * (t // seq_size))
        local = {k: v[:, cols] for k, v in local.items()}
    return local, _loss_denominator(local) / total


def _loss_denominator(batch: Dict[str, Any]) -> float:
    """What a mean loss over this batch divides by, as Transformer.loss
    takes it: the mask's sum (at least 1) where the batch holds a "mask",
    else its targets' count (the tokens after the shift), or its rows for
    a batch of neither."""
    mask = batch.get("mask")
    if mask is not None:
        return max(float(torch.as_tensor(mask).sum()), 1.0)
    rows = len(next(iter(batch.values())))
    if "targets" in batch:
        return float(rows * batch["targets"].shape[1])
    if "tokens" in batch:
        return float(rows * (batch["tokens"].shape[1] - 1))
    return float(rows)


def _all_reduce_weighted(grads, loss: torch.Tensor, share: float,
                         groups) -> torch.Tensor:
    """Replace each grad by the sum over the batch's axes of the ranks'
    grads, each weighed by its rank's share of the loss, in one
    collective an axis that also carries the loss; returns the global
    loss."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.reshape(1).to(grads[0].dtype)])
    flat *= share
    for group in groups:
        dist.all_reduce(flat, group=group)
    for g, chunk in zip(grads, flat[:-1].split([g.numel() for g in grads])):
        g.copy_(chunk.view_as(g))
    return flat[-1].to(loss.dtype)
