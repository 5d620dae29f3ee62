"""Flash attention: three CUDA kernels for sm_90a, their plain versions,
and the autograd function that joins them.

The JAX package reaches JAX's Pallas TPU flash-attention kernel from
``ray_tpu/ops/attention.py:flash_attention``. Its three ``pallas_call``s
(forward, dK/dV, dQ) are ported here as ``csrc/flash_fwd.cu``,
``csrc/flash_bwd_dkv.cu`` and ``csrc/flash_bwd_dq.cu``.

Every function takes the public ``[B, T, H, D]`` layout; ``lse`` and ``di``
are f32 ``[B, H, T]``. A wrapper (``flash_fwd``, ``flash_bwd_dkv``,
``flash_bwd_dq``) runs the plain version for CPU tensors and launches its
kernel for CUDA tensors; the kernel path raises on anything it does not
take (dtype other than bf16, D not in {64, 128}, a non-contiguous last
dimension) and never falls back. ``launches`` counts kernel launches per
wrapper.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ray_tpu_torch.ops import _build

# kernel launches per wrapper since the last reset_launches()
launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0,
                            "flash_bwd_dq": 0}

KERNEL_HEAD_DIMS = (64, 128)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---- plain versions: the functions the kernels compute, in f32 ---------

def _probs(q, k, lse, scale, causal):
    """P = exp(scale * Q K^T - lse) [B, H, Tq, Tk] in f32, 0 where masked."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~keep, 0.0)
    return p


def flash_fwd_ref(q, k, v, scale: float, causal: bool):
    """(o [B,T,H,D] in q's dtype, lse [B,H,T] f32): softmax attention with
    the row log-sum-exp the backward rebuilds P from."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def flash_bwd_dkv_ref(q, k, v, do, lse, di, scale: float, causal: bool):
    """(dk, dv) in k's and v's dtypes, from P rebuilt out of lse and
    di = rowsum(o * do) [B,H,T]."""
    p = _probs(q, k, lse, scale, causal)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - di[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, di, scale: float, causal: bool):
    """dq in q's dtype, from P rebuilt out of lse and di."""
    p = _probs(q, k, lse, scale, causal)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


# ---- kernel path --------------------------------------------------------

def _check_operands(name, qkv, stats=()):
    """Raise unless every operand suits the kernel: CUDA, one device, bf16
    [B,T,H,D] of one shape with D in {64, 128}, a contiguous last
    dimension and 16-byte aligned rows; stats f32 [B,H,T] contiguous."""
    q = qkv[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel path takes CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"{name}: expected [B, T, H, D], got {tuple(q.shape)}")
    b, t, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    for x in qkv:
        if x.device != q.device:
            raise ValueError(f"{name}: operands on {x.device} and {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"{name}: shapes {tuple(x.shape)} and "
                             f"{tuple(q.shape)} differ (self-attention, "
                             "equal heads: repeat GQA kv heads first)")
        if (x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(f"{name}: needs a contiguous last dimension and "
                             f"16-byte aligned rows, got strides {x.stride()}")
    for s in stats:
        if (s.device != q.device or s.dtype != torch.float32
                or s.shape != (b, h, t) or not s.is_contiguous()):
            raise ValueError(f"{name}: lse/di must be contiguous f32 "
                             f"[{b}, {h}, {t}] on {q.device}")


def _strides(x):
    return x.stride(0), x.stride(1), x.stride(2)


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    launches[name] += 1


def _flash_fwd_cuda(q, k, v, scale: float, causal: bool):
    _check_operands("flash_fwd", (q, k, v))
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = _build.kernel("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, h, d, *_strides(q), *_strides(k), *_strides(v),
        float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _launched("flash_fwd", err)
    return o, lse


def _flash_bwd_dkv_cuda(q, k, v, do, lse, di, scale: float, causal: bool):
    _check_operands("flash_bwd_dkv", (q, k, v, do), (lse, di))
    b, t, h, d = q.shape
    dk = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    err = _build.kernel("flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, h, d, *_strides(q), *_strides(k), *_strides(v), *_strides(do),
        float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _launched("flash_bwd_dkv", err)
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, do, lse, di, scale: float, causal: bool):
    _check_operands("flash_bwd_dq", (q, k, v, do), (lse, di))
    b, t, h, d = q.shape
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    err = _build.kernel("flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        b, t, h, d, *_strides(q), *_strides(k), *_strides(v), *_strides(do),
        float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _launched("flash_bwd_dq", err)
    return dq


# ---- wrappers: plain version on the CPU, the kernel on the card ---------

def flash_fwd(q, k, v, scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, scale, causal)
    return _flash_fwd_cuda(q, k, v, scale, causal)


def flash_bwd_dkv(q, k, v, do, lse, di, scale: float, causal: bool):
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, di, scale, causal)
    return _flash_bwd_dkv_cuda(q, k, v, do, lse, di, scale, causal)


def flash_bwd_dq(q, k, v, do, lse, di, scale: float, causal: bool):
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, di, scale, causal)
    return _flash_bwd_dq_cuda(q, k, v, do, lse, di, scale, causal)


def row_dot(o, do):
    """di = rowsum(o * do) in f32, [B,T,H,D] -> [B,H,T] contiguous (the
    JAX backward computes it outside its kernels the same way)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """o = attention(q, k, v) on [B, T, H, D] with equal head counts.

    Forward saves (q, k, v, o, lse); backward computes di, then dK/dV,
    then dQ, through the wrappers above."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = row_dot(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, ctx.scale, ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, di, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None
