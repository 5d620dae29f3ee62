"""Attention ops (counterpart of ray_tpu/ops/attention.py).

Dense attention accumulates the scores and the probs @ V contraction in
f32 whatever the compute dtype, as the JAX ops do with
preferred_element_type. flash_attention runs the hand-written CUDA kernels
on the card and their plain versions on the CPU (ops/flash_attention.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import FlashAttentionFn


def _repeat_kv(x, hq: int):
    """[B,T,Hkv,D] -> [B,T,Hq,D]: query head h reads kv head h // (Hq/Hkv),
    the same head order as jnp.repeat on axis 2."""
    hkv = x.shape[2]
    if hq == hkv:
        return x
    if hq % hkv:
        raise ValueError(
            f"GQA needs kv heads ({hkv}) to divide query heads ({hq})")
    return x.repeat_interleave(hq // hkv, dim=2)


def gqa_scores(q, k, scale: float):
    """Scores [B, Hq, Tq, Tk] (f32) for MHA or GQA inputs q [B,Tq,Hq,D],
    k [B,Tk,Hkv,D] with Hkv | Hq."""
    k = _repeat_kv(k, q.shape[2])
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def gqa_pv(p, v):
    """probs [B, Hq, Tq, Tk] @ v [B, Tk, Hkv, D] -> [B, Tq, Hq, D], f32
    accumulation."""
    v = _repeat_kv(v, p.shape[1])
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())


def dense_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Multi-head / grouped-query attention on [batch, seq, heads,
    head_dim]; k/v may carry fewer (kv) heads than q."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = gqa_scores(q, k, scale)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    # probs are rounded to v's dtype before the f32-accumulated product,
    # as jax.nn.softmax(...).astype(v.dtype) does
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return gqa_pv(p, v).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Flash attention on [batch, seq, heads, head_dim].

    CUDA tensors go through the three kernels (bf16, head_dim 64 or 128,
    any T; anything else raises); CPU tensors through their plain
    versions. GQA k/v are repeated up to the query heads first, as the
    JAX op does for its kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    h = q.shape[2]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    return FlashAttentionFn.apply(q, k, v, float(scale), bool(causal)).to(q.dtype)
