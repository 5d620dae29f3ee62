"""Training-step factory (counterpart of ray_tpu/parallel/train_step.py).

The step: loss, backward, the global gradient norm, and an AdamW update
equal to optax.adamw. The JAX step is one jitted function with sharded
state; here PyTorch runs eagerly and updates the params in place (so
``state["params"]`` holds the live tensors the loss reads).

With a data mesh of size D (parallel.make_mesh) the step keeps the JAX
contract: every rank passes the global batch, and the step is the one
the JAX package computes on the whole of it. Rank r takes rows
[r B/D, (r+1) B/D). The loss is a mean, as Transformer.loss's is: over
the batch's "mask" where it holds one, else over its rows. So each rank
weighs its loss and grads by its share of the global denominator (its
mask sum over the global one, which every rank reads from the global
batch; B/D over B unmasked) and one all-reduce sums them, before the
norm and the update: every rank's params stay equal, and the loss is
the global one even where the ranks' masks differ. At D = 1 there is no
collective, as XLA emits none. Sharded axes (FSDP, tensor) come with a
later slice of the port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.mesh import (AXIS_DATA, MESH_AXIS_ORDER,
                                         check_data_only)

OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


# optax.adamw's defaults, which no caller of the port changes
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def adamw(learning_rate: float, weight_decay: float = 1e-4) -> OptimizerFactory:
    """optax.adamw with mask=None, as a factory of torch.optim.AdamW.

    Both take eps outside the square root, bias-correct both moments and
    decay every param by lr * weight_decay * p (decoupled), so the update
    is the same. optax's own default decay is 1e-4: pass it explicitly."""
    def make(params):
        return torch.optim.AdamW(params, lr=learning_rate, betas=(_B1, _B2),
                                 eps=_EPS, weight_decay=weight_decay)
    return make


def make_train_step(
        loss_fn: Callable[[Dict[str, torch.Tensor], Dict[str, Any]], Any],
        param_specs: Any = None,
        mesh=None,
        *,
        optimizer: Optional[OptimizerFactory] = None,
        device: DeviceLike = None,
) -> Tuple[Callable, Callable]:
    """Build (init_state, train_step).

    loss_fn(params, batch) -> scalar loss (or (loss, aux dict)), where
    params is the name -> tensor dict given to init_state (e.g.
    ``dict(model.named_parameters())``). init_state(params) -> state dict;
    train_step(state, batch) -> (state, {"loss", "grad_norm", "step"}).
    param_specs (logical sharding) is accepted and not used yet: on a
    data mesh every param is replicated. mesh=None is the single-device
    step; a mesh with any axis but `data` above size 1 raises.
    """
    dev = resolve_device(device)
    group, rank, size = (None, 0, 1) if mesh is None \
        else _data_axis(mesh, dev)
    if optimizer is None:
        optimizer = adamw(3e-4, weight_decay=0.01)

    def init_state(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        params = dict(params)
        for name, p in params.items():
            if p.device.type != dev.type or (
                    dev.index is not None and p.device.index != dev.index):
                raise ValueError(f"param {name} is on {p.device}, the step "
                                 f"runs on {dev}")
        return {"params": params,
                "opt_state": optimizer(list(params.values())),
                "step": 0}

    def train_step(state, batch):
        params = state["params"]
        if size > 1:
            total = _loss_denominator(batch)
            batch = _rows_of_rank(batch, rank, size)
            share = _loss_denominator(batch) / total
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for p in params.values():
            p.grad = None
        out = loss_fn(params, batch)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        loss.backward()
        grads = []
        for p in params.values():
            if p.grad is None:  # unused param: a zero grad, as jax.grad gives
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if size > 1:
            loss = _all_reduce_weighted(grads, loss.detach(), share, group)
        # global L2 norm over every grad, before the update
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
        state["opt_state"].step()
        step = state["step"] + 1
        new_state = {"params": params, "opt_state": state["opt_state"],
                     "step": step}
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "step": step,
                   **aux}
        return new_state, metrics

    return init_state, train_step


def _data_axis(mesh, dev: torch.device):
    """(group, rank, size) of the mesh's data axis; raises for a mesh
    the data-parallel step cannot run on."""
    names = tuple(mesh.mesh_dim_names or ())
    if names != MESH_AXIS_ORDER:
        raise ValueError(f"a mesh from parallel.make_mesh is needed (axes "
                         f"{MESH_AXIS_ORDER}), got axes {names}")
    check_data_only(dict(zip(names, mesh.shape)))
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is over {mesh.device_type} and the "
                         f"step runs on {dev}")
    return (mesh.get_group(AXIS_DATA), mesh.get_local_rank(AXIS_DATA),
            mesh.size(MESH_AXIS_ORDER.index(AXIS_DATA)))


def _rows_of_rank(batch: Dict[str, Any], rank: int, size: int):
    """Rank `rank`'s rows of the global batch: [r B/D, (r+1) B/D)."""
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"batch entries differ in rows: {sorted(rows)}")
    (b,) = rows
    if b % size:
        raise ValueError(f"a global batch of {b} rows does not split over "
                         f"a data axis of {size}")
    n = b // size
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _loss_denominator(batch: Dict[str, Any]) -> float:
    """What a mean loss over these rows divides by, as Transformer.loss
    takes it: the mask's sum (at least 1) where the batch holds a "mask",
    else the row count."""
    mask = batch.get("mask")
    if mask is None:
        return float(len(next(iter(batch.values()))))
    return max(float(torch.as_tensor(mask).sum()), 1.0)


def _all_reduce_weighted(grads, loss: torch.Tensor, share: float,
                         group) -> torch.Tensor:
    """Replace each grad by the sum over the data axis of the ranks'
    grads, each weighed by its rank's share of the loss, in one
    collective that also carries the loss; returns the global loss."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.reshape(1).to(grads[0].dtype)])
    flat *= share
    dist.all_reduce(flat, group=group)
    for g, chunk in zip(grads, flat[:-1].split([g.numel() for g in grads])):
        g.copy_(chunk.view_as(g))
    return flat[-1].to(loss.dtype)
