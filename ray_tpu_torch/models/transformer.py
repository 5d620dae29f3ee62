"""Decoder-only transformer (counterpart of ray_tpu/models/transformer.py).

An nn.Module holding the JAX package's parameter layout unchanged:
stacked layers (leading dim n_layers), fused ``wqkv (l, d, 3, nh, hd)``
for MHA or ``wq`` plus ``wkv (l, d, 2, nkv, hd)`` for GQA, fused
``w_gateup (l, d, 2, f)``, ``w_down (l, f, d)``, ``wo (l, nh, hd, d)``, and
an ``embed`` table the head reuses when embeddings are tied. So weights
move between the two by a rename (models/convert.py).

Params stay in cfg.param_dtype and are cast to cfg.dtype at each use, as
the JAX layer body does. RMSNorm runs in f32, RoPE is half-split, the
attention products and the lm-head logits accumulate in f32, and the
logits come out f32.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.configs import TransformerConfig, torch_dtype
from ray_tpu_torch.ops.attention import dense_attention, flash_attention

_LATER_PARALLEL = ("is not ported yet: it comes with the sequence, "
                   "pipeline and expert parallelism slice of the port "
                   "(ROADMAP.md)")


def _rope_tables(positions, head_dim: int, theta: float):
    """cos/sin tables [..., T, half] (f32) for explicit positions."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x, cos, sin):
    """Rotary embedding of [..., T, H, D] given [..., T, half] tables; the
    two halves of D rotate together (half-split, not interleaved)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]  # broadcast over heads: [..., T, 1, half]
    s = sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def _rmsnorm(x, w, eps: float):
    """f32 mean of squares, cast to x's dtype, then times w cast to it."""
    x32 = x.to(torch.float32)
    scale = torch.reciprocal(
        torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps))
    return (x32 * scale).to(x.dtype) * w.to(x.dtype)


class _DotF32(torch.autograd.Function):
    """x2 [M, d] @ w [d, n] -> f32 [M, n] for bf16 (or f16) operands, the
    counterpart of einsum(..., preferred_element_type=f32).

    A bf16 torch.matmul would round its f32 sums to bf16. On the card the
    product runs as a bf16 GEMM whose output type is f32 (torch.mm with
    out_dtype, which has no derivative of its own); on the CPU the
    operands are widened to f32 first, which gives the same exact
    products and f32 sums. The backward rounds the f32 cotangent to the
    operands' dtype and runs two plain GEMMs, as the TPU's default matmul
    precision rounds f32 operands to bf16."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        if x2.is_cuda:
            return torch.mm(x2, w, out_dtype=torch.float32)
        return x2.to(torch.float32) @ w.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.t(), x2.t() @ g


def _dot_f32(x, w):
    """x [..., d] @ w [d, n] -> f32 logits [..., n], sums in f32."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    out = _DotF32.apply(x.reshape(-1, x.shape[-1]), w)
    return out.view(*x.shape[:-1], w.shape[-1])


def _nll(logits, targets):
    """Next-token negative log-likelihood per position, f32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return logz - gold


class Transformer(nn.Module):
    """The flagship decoder. ``Transformer(cfg, device=None)`` builds it on
    the card (raising without CUDA) unless a device is named, and fills
    its params from a torch.Generator seeded with ``seed``."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 *, seed: int = 0):
        super().__init__()
        if cfg.attention_impl not in ("auto", "dense", "flash", "ring",
                                      "ulysses"):
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
        if cfg.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={cfg.attention_impl!r} {_LATER_PARALLEL}")
        if cfg.moe_experts:
            raise NotImplementedError(f"moe_experts > 0 {_LATER_PARALLEL}")
        if cfg.remat:
            raise NotImplementedError(
                "remat=True is not ported yet: layer rematerialization "
                "comes with the sharded-step slice of the port (ROADMAP.md)")
        self.cfg = cfg
        dev = resolve_device(device)
        pdt = torch_dtype(cfg.param_dtype)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=pdt, device=dev))

        d, hd = cfg.d_model, cfg.head_dim
        nh, nkv, f, l = cfg.n_heads, cfg.kv_heads, cfg.ff_dim, cfg.n_layers
        layers = {
            "attn_norm": param(l, d),
            "wo": param(l, nh, hd, d),
            "mlp_norm": param(l, d),
            "w_gateup": param(l, d, 2, f),
            "w_down": param(l, f, d),
        }
        if nkv == nh:
            layers["wqkv"] = param(l, d, 3, nh, hd)
        else:
            layers["wq"] = param(l, d, nh, hd)
            layers["wkv"] = param(l, d, 2, nkv, hd)
        self.embed = param(cfg.vocab_size, d)
        self.layers = nn.ParameterDict(layers)
        self.final_norm = param(d)
        if not cfg.tie_embeddings:
            self.lm_head = param(d, cfg.vocab_size)
        self.init(torch.Generator(device=dev).manual_seed(seed))

    # ---- parameter construction ------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Fill the params with Transformer.init's distributions (the
        values differ from JAX's: another generator)."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.ff_dim
        stddev = {
            "embed": 0.02,
            "layers.wo": (cfg.n_heads * cfg.head_dim) ** -0.5,
            "layers.w_gateup": d ** -0.5,
            "layers.w_down": f ** -0.5,
            "layers.wqkv": d ** -0.5,
            "layers.wq": d ** -0.5,
            "layers.wkv": d ** -0.5,
            "lm_head": d ** -0.5,
        }
        for name, p in self.named_parameters():
            if name in stddev:
                noise = torch.randn(p.shape, generator=generator,
                                    dtype=torch.float32, device=p.device)
                p.copy_(noise * stddev[name])
            else:  # the three norms
                p.fill_(1.0)

    def load_jax_params(self, tree: Dict[str, Any]) -> None:
        """Load a JAX Transformer.init tree (numpy or jax arrays)."""
        from ray_tpu_torch.models.convert import params_from_jax
        self.load_state_dict(
            params_from_jax(tree, self.cfg, self.embed.device))

    # ---- forward ----------------------------------------------------
    def hidden(self, tokens, positions=None):
        """tokens [B, T] -> final-norm hidden states [B, T, d] in the
        compute dtype."""
        cfg = self.cfg
        cdt = torch_dtype(cfg.dtype)
        tokens = torch.as_tensor(tokens, device=self.embed.device).long()
        t = tokens.shape[1]
        if positions is None:
            positions = torch.arange(t, device=tokens.device)[None, :]
        x = F.embedding(tokens, self.embed).to(cdt)
        cos, sin = _rope_tables(torch.as_tensor(positions, device=tokens.device),
                                cfg.head_dim, cfg.rope_theta)
        # one unbind per stacked param: its backward stacks the per-layer
        # grads once (indexing p[i] per layer would add a full-size zero
        # tensor per layer in backward)
        per_layer = {name: p.unbind(0) for name, p in self.layers.items()}
        for i in range(cfg.n_layers):
            x = self._layer(x, {n: ps[i] for n, ps in per_layer.items()},
                            cos, sin)
        return _rmsnorm(x, self.final_norm, cfg.norm_eps)

    def _layer(self, x, lp, cos, sin):
        cfg = self.cfg
        cdt = x.dtype
        b, t, d = x.shape
        nh, nkv, hd, f = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.ff_dim
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        if nkv == nh:
            qkv = h @ lp["wqkv"].to(cdt).reshape(d, 3 * nh * hd)
            q, k, v = qkv.view(b, t, 3, nh, hd).unbind(2)
        else:
            q = (h @ lp["wq"].to(cdt).reshape(d, nh * hd)).view(b, t, nh, hd)
            kv = h @ lp["wkv"].to(cdt).reshape(d, 2 * nkv * hd)
            k, v = kv.view(b, t, 2, nkv, hd).unbind(2)
        q = _rope(q, cos, sin)
        k = _rope(k, cos, sin)
        attn = dense_attention if cfg.attention_impl == "dense" else flash_attention
        o = attn(q, k, v, causal=True, scale=hd ** -0.5)
        x = x + o.reshape(b, t, nh * hd) @ lp["wo"].to(cdt).reshape(nh * hd, d)

        h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        gate, up = (h @ lp["w_gateup"].to(cdt).reshape(d, 2 * f)).view(
            b, t, 2, f).unbind(2)
        ff = F.silu(gate) * up
        return x + ff @ lp["w_down"].to(cdt)

    def _head(self, dtype):
        """The lm head as a [d, vocab] matrix in `dtype` (a transposed view
        of embed when tied)."""
        if self.cfg.tie_embeddings:
            return self.embed.to(dtype).t()
        return self.lm_head.to(dtype)

    def _head_logits(self, x):
        """hidden states [B, T, d] -> f32 logits [B, T, vocab]."""
        return _dot_f32(x, self._head(x.dtype))

    def forward(self, tokens, positions=None):
        """tokens [B, T] -> logits [B, T, vocab] (f32)."""
        return self._head_logits(self.hidden(tokens, positions=positions))

    apply = forward

    def pipeline_loss(self, *args, **kwargs):
        raise NotImplementedError(f"pipeline_loss {_LATER_PARALLEL}")

    # ---- loss -------------------------------------------------------
    def loss(self, batch: Dict[str, Any]):
        """Next-token cross-entropy. batch = {"tokens": [B,T+1]} or
        {"tokens", "targets"}, with an optional "mask" [B,T]; returns the
        scalar mean loss (f32)."""
        dev = self.embed.device
        if "targets" in batch:
            tokens = torch.as_tensor(batch["tokens"], device=dev)
            targets = torch.as_tensor(batch["targets"], device=dev)
        else:
            full = torch.as_tensor(batch["tokens"], device=dev)
            tokens, targets = full[:, :-1], full[:, 1:]
        targets = targets.long()
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev).to(torch.float32)
        b, t = tokens.shape
        x = self.hidden(tokens)
        chunk = self.cfg.loss_chunk
        if not (chunk and t > chunk and t % chunk == 0):
            nll = _nll(self._head_logits(x), targets)
            if mask is not None:
                return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
            return torch.mean(nll)

        # Chunked head + cross-entropy: one [B, chunk, vocab] f32 logits
        # block at a time, recomputed in backward (torch.utils.checkpoint
        # in place of jax.checkpoint).
        head = self._head(x.dtype)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(t // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            nll = checkpoint(lambda xc, tc: _nll(_dot_f32(xc, head), tc),
                             x[:, sl], targets[:, sl], use_reentrant=False)
            total = total + torch.sum(nll if mask is None else nll * mask[:, sl])
        if mask is None:
            return total / (b * t)
        return total / torch.clamp(mask.sum(), min=1.0)
