"""Training-step factory (counterpart of ray_tpu/parallel/train_step.py).

The single-device step: loss, backward, the global gradient norm, and an
AdamW update equal to optax.adamw. The JAX step is one jitted function
with sharded state; here PyTorch runs eagerly and updates the params in
place (so ``state["params"]`` holds the live tensors the loss reads).
Meshes and sharding come with a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device

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
    param_specs (logical sharding) is accepted and not used yet; a mesh
    raises until the sharded step is ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a mesh is not ported yet: the sharded train step (mesh and "
            "sharding rules) comes with a later slice of the port "
            "(ROADMAP.md); call make_train_step(loss_fn) for one device")
    dev = resolve_device(device)
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
