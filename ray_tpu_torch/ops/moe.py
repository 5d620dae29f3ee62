"""Mixture-of-Experts FFN (counterpart of ray_tpu/ops/moe.py): a top-k
router with bounded expert capacity, Switch/GShard style.

It computes what the JAX module's one-hot dispatch and combine einsums
compute, with index copies and adds in their place: every (token, slot)
pair takes the next free place of its expert's buffer, slot 0 of every
token before slot 1 (the JAX cumsum over the flattened [k, tokens]
order), and a pair past the expert's capacity is dropped (adds nothing).
The router runs in f32 (the f32 router promotes the activations, as the
JAX matmul does); gelu is the tanh form, jax.nn.gelu's default. The
experts compute in f32 with f32 operands, as the JAX einsums do: its
dispatch one-hots are f32, so the experts' input, both GEMMs, the gelu
and the combine promote to f32 whatever the compute dtype. The
experts' input holds the activations' values and each GEMM reads its
weights' values (cast to the compute dtype by the caller) widened to
f32; the caller casts the f32 output back.

Distributed (`MoEAxes`, from the transformer on a mesh): each rank of
the `expert` axis holds n_experts / expert of them and runs only those;
the tokens are the rank's own columns of the global batch, replicated
over `expert`. The statistics the JAX code takes over the global batch
stay global: each rank all-gathers the tokens' expert indices (a few KB)
over the axes that split the tokens, takes every pair's place in the
global b*T + t order and keeps its own, and the router probs' sum of the
aux loss is all-reduced before its product. The experts' input is
Megatron's f over `expert` (and `tensor`, which splits each expert's
hidden dim), and each slot's expert output is summed over them, so the
router, the gates and the aux loss run replicated and their grads are
neither partial nor counted twice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.sharding import (MeshAxis, all_gather_dim,
                                             sum_across, sum_over,
                                             to_parallel)

# Logical specs for param placement (the JAX table).
MOE_PARAM_SPECS = {
    "w_router": ("embed", None),
    "w_up": ("expert", "embed", "mlp"),
    "w_down": ("expert", "mlp", "embed"),
}

_ONE = MeshAxis("", 1, 0, None)


@dataclasses.dataclass(frozen=True)
class MoEAxes:
    """How one rank's MoE layer sits on the mesh. expert: the axis the
    experts split over; tensor: the axis each expert's hidden dim splits
    over; tokens: the (axis, dim) pairs that split the [B, T] tokens,
    innermost first (seq over dim 1, then fsdp and data over dim 0)."""

    expert: MeshAxis = _ONE
    tensor: MeshAxis = _ONE
    tokens: Tuple[Tuple[MeshAxis, int], ...] = ()


def init_moe_params(key, d_model: int, d_ff: int, n_experts: int,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The JAX init_moe_params's distributions (another generator, so
    other values): `key` an int seed or a torch.Generator; on the card
    unless `device` names another."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(key))

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev)

    return {"w_router": normal(d_model, n_experts) * 0.02,
            "w_up": normal(n_experts, d_model, d_ff) * (2.0 / d_model) ** 0.5,
            "w_down": normal(n_experts, d_ff, d_model) * (2.0 / d_ff) ** 0.5}


def _route(x2, w_router, k: int):
    """(probs [N, E] f32, gates [N, k] f32 normalised, expert ids [N, k])."""
    probs = torch.softmax(x2.to(torch.float32) @ w_router.to(torch.float32),
                          dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def _positions(idx, n_experts: int):
    """Each (token, slot)'s place in its expert's buffer, [N, k]: the
    count of earlier pairs of the same expert in slot-major order (every
    token's slot 0, then every token's slot 1, ...)."""
    n, k = idx.shape
    sel = idx.t().reshape(-1)
    onehot = F.one_hot(sel, n_experts)
    before = (onehot.cumsum(0) - onehot).gather(1, sel[:, None])[:, 0]
    return before.view(k, n).t()


def moe(x, w_router, w_up, w_down, *, num_selected: int = 2,
        capacity_factor: float = 1.25, axes: MoEAxes = MoEAxes()):
    """x [b, t, d] (this rank's tokens) -> (y [b, t, d] f32, aux f32,
    share of the global (token, slot) pairs dropped). w_router [d, E]
    (all experts); w_up [E_local, d, f_local] and w_down [E_local,
    f_local, d] in the compute dtype, this rank's experts (and hidden
    columns), which run in f32."""
    b, t, d = x.shape
    n_experts = w_router.shape[1]
    k = min(num_selected, n_experts)
    x2 = x.reshape(b * t, d)
    probs, gates, idx = _route(x2, w_router, k)

    # every pair's place in the global order, from the gathered ids
    ids = idx.view(b, t, k)
    start, extent = [0, 0], [b, t]
    for axis, dim in axes.tokens:
        ids = all_gather_dim(ids, axis, dim)
        start[dim] += axis.coord * extent[dim]
        extent[dim] *= axis.size
    n_tokens = ids.shape[0] * ids.shape[1]
    capacity = max(1, int(capacity_factor * n_tokens * k / n_experts))
    pos = _positions(ids.reshape(-1, k), n_experts).view(ids.shape)
    kept = pos < capacity
    frac = torch.bincount(ids[kept], minlength=n_experts).to(
        torch.float32) / max(n_tokens * k, 1)
    dropped = 1.0 - kept.sum() / (n_tokens * k)
    mine = (slice(start[0], start[0] + b), slice(start[1], start[1] + t))
    pos, kept = pos[mine].reshape(b * t, k), kept[mine].reshape(b * t, k)

    # load-balancing aux loss (Switch eq. 4) over the global batch
    token_axes = [axis for axis, _ in axes.tokens]
    prob_sum = sum_across(probs.sum(0), token_axes)
    aux = n_experts * torch.sum(frac * prob_sum / n_tokens)

    # this rank's experts: dispatch, the two GEMMs, each slot's output
    e_local = w_up.shape[0]
    e0 = axes.expert.coord * e_local
    local = kept & (idx >= e0) & (idx < e0 + e_local)
    tok, slot = local.nonzero(as_tuple=True)
    place = (idx[tok, slot] - e0) * capacity + pos[tok, slot]
    xe = to_parallel(x2, (axes.expert, axes.tensor))
    f32 = torch.float32
    expert_in = xe.new_zeros(e_local * capacity, d, dtype=f32).index_copy(
        0, place, xe[tok].to(f32))
    h = F.gelu(torch.bmm(expert_in.view(e_local, capacity, d),
                         w_up.to(f32)), approximate="tanh")
    out = torch.bmm(h, w_down.to(f32)).view(e_local * capacity, d)
    per_slot = out.new_zeros(b * t * k, d).index_copy(
        0, tok * k + slot, out[place])
    per_slot = sum_over(per_slot.view(b * t, k, d), (axes.expert,
                                                     axes.tensor))
    y = (gates[..., None] * per_slot).sum(1)
    return y.view(b, t, d), aux, dropped


def moe_ffn(params: Dict[str, Any], x, *, num_selected: int = 2,
            capacity_factor: float = 1.25,
            rules: Optional[Any] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN on one device. x: [tokens, d_model];
    returns (y [tokens, d_model] f32, aux_loss f32), aux_loss the
    load-balancing loss (E x mean dispatch fraction . mean router prob).
    A (token, slot) pair over its expert's capacity contributes zero.
    `rules` is accepted for the JAX signature; nothing is placed here."""
    y, aux, _ = moe(x[None], params["w_router"], params["w_up"],
                    params["w_down"], num_selected=num_selected,
                    capacity_factor=capacity_factor)
    return y[0], aux


def moe_ffn_dense_reference(params: Dict[str, Any], x, *,
                            num_selected: int = 2):
    """Un-capacitated dense check: every token runs every selected
    expert (no drops)."""
    n_experts = params["w_router"].shape[1]
    _, gates, idx = _route(x, params["w_router"], min(num_selected,
                                                      n_experts))
    h = F.gelu(torch.einsum("nd,edf->nef", x, params["w_up"]),
               approximate="tanh")
    all_out = torch.einsum("nef,efd->ned", h, params["w_down"])
    dense = torch.zeros(x.shape[0], n_experts, dtype=gates.dtype,
                        device=x.device).scatter(1, idx, gates)
    return torch.einsum("ne,ned->nd", dense, all_out.to(dense.dtype))
