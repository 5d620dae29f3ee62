"""Transformer configurations (counterpart of ray_tpu/models/configs.py).

A copy of the JAX package's dataclass and presets, so that the port
imports nothing of ray_tpu. A field that only the JAX package's compiler
reads (scan_unroll) is kept so that a config means the same thing in
both; the port ignores it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None      # None -> = n_heads (MHA)
    d_ff: Optional[int] = None            # None -> 4*d_model
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # "auto" | "dense" | "flash" | "ring" | "ulysses". auto = flash when
    # the seq axis is unsharded (always, in the port so far); dense =
    # materialized-scores attention; ring/ulysses are not ported yet.
    attention_impl: str = "dense"
    # params kept in param_dtype, compute runs in dtype (bf16 on the card;
    # the products accumulate in f32)
    dtype: Any = "bfloat16"
    param_dtype: Any = "float32"
    remat: bool = False
    remat_policy: str = "full"
    # chunk the lm-head + cross-entropy over the sequence axis so the
    # [B,T,vocab] f32 logits never materialize at once; 0 = off.
    loss_chunk: int = 256
    scan_unroll: int = 1
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coeff: float = 0.01

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_params(self) -> int:
        d, l, f, v = self.d_model, self.n_layers, self.ff_dim, self.vocab_size
        hd, nh, nkv = self.head_dim, self.n_heads, self.kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp = 3 * d * f
        norms = 2 * d
        head = 0 if self.tie_embeddings else d * v
        return v * d + l * (attn + mlp + norms) + d + head


def torch_dtype(name: Any) -> torch.dtype:
    """'bfloat16' / 'float32' / 'float16' (or a torch.dtype) -> torch.dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


TINY = TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128)

# GPT-2 small scale (125M): 12 layers, d_model 768, 6 heads of head_dim
# 128, RoPE, tied embeddings; vocab 50257 padded to 50304.
GPT2_125M = TransformerConfig(
    vocab_size=50304,
    d_model=768, n_layers=12, n_heads=6, d_ff=3072, max_seq_len=1024,
    tie_embeddings=True)

LLAMA2_7B = TransformerConfig(
    vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
    n_kv_heads=32, d_ff=11008, max_seq_len=4096, norm_eps=1e-5,
    remat=True)
