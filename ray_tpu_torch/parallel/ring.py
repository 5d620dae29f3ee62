"""Ring attention (counterpart of ray_tpu/parallel/ring.py): exact
attention over a sequence sharded across the `seq` axis.

Each rank holds the columns [r T/n, (r+1) T/n) of q, k and v. K and V go
once around the ring, one hop at a time; at each hop the rank attends its
queries to the block it holds and merges the result into its running
output by the block's row log-sum-exp, the online softmax in lse form.
After n hops every query has seen every key once. The block attention is
the flash kernels' (ops/flash_attention.py: the kernels on CUDA, their
plain versions on the CPU); the exchange is one batch_isend_irecv a hop
(parallel/sharding.exchange).

The backward is the ring-flash backward: di = rowsum(o dO) of the merged
output, then at each hop the dK/dV and dQ kernels with the merged lse and
di; dQ accumulates on the rank, and dK and dV ride around the ring with K
and V, arriving home after n hops.

Causal masking follows the block's origin: the diagonal block (the
rank's own) takes the causal flag, a block from an earlier shard none,
and a block from a later shard is skipped (it would be wholly masked);
the exchange runs on every hop all the same, so every rank makes the
same exchanges in the same order.

GQA: K and V move at their true kv-head width, as the JAX ring's do;
each block repeats them to the query heads for the kernels (which take
equal heads) and sums each group's dK/dV back before it moves.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.attention import _repeat_kv
from ray_tpu_torch.ops.flash_attention import (flash_bwd_dkv, flash_bwd_dq,
                                               flash_fwd_op, row_dot)
from ray_tpu_torch.parallel.mesh import AXIS_SEQ
from ray_tpu_torch.parallel.sharding import MeshAxis, exchange, mesh_axis


def _block_attention(q, k, v, scale: float, causal: bool):
    """One hop's block: (o [B,Tq,H,D] in q's dtype, lse f32 [B,H,Tq])
    through the flash forward operator (which the remat "dots" policy
    saves by name); k, v [B,Tk,Hkv,D] are repeated to q's heads first."""
    h = q.shape[2]
    k = _repeat_kv(k, h).contiguous()
    v = _repeat_kv(v, h).contiguous()
    return flash_fwd_op(q, k, v, scale, causal)


def _merge(o, lse, o_b, lse_b):
    """Merge block (o_b, lse_b) into the running (o f32, lse), or start it
    when o is None: the JAX (m, l) merge in lse form, in f32. A row that
    no live block has reached keeps lse -inf and weight 0 (never NaN)."""
    if o is None:
        return o_b.float(), lse_b
    new = torch.logaddexp(lse, lse_b)

    def weight(x):   # [B,H,T] -> [B,T,H,1]
        w = torch.where(torch.isneginf(x), 0.0, torch.exp(x - new))
        return w.transpose(1, 2)[..., None]

    return o * weight(lse) + o_b.float() * weight(lse_b), new


def _finish(o, lse, dtype):
    """The merged output in `dtype`, 0 on a row no live block reached."""
    dead = torch.isneginf(lse).transpose(1, 2)[..., None]
    return o.masked_fill(dead, 0.0).to(dtype)


def _block_grads(q, k, v, do, lse, di, scale: float, causal: bool):
    """One hop's backward: (dq [B,Tq,H,D] f32, dk, dv [B,Tk,Hkv,D] f32)
    of the block, through the dK/dV and dQ kernels with the merged lse
    and di; each group's dk/dv summed back to the kv heads."""
    h, hkv = q.shape[2], k.shape[2]
    kr = _repeat_kv(k, h).contiguous()
    vr = _repeat_kv(v, h).contiguous()
    dk, dv = flash_bwd_dkv(q, kr, vr, do, lse, di, scale, causal)
    dq = flash_bwd_dq(q, kr, vr, do, lse, di, scale, causal)
    if h != hkv:
        b, t, _, d = dk.shape
        dk = dk.float().view(b, t, hkv, h // hkv, d).sum(3)
        dv = dv.float().view(b, t, hkv, h // hkv, d).sum(3)
    return dq.float(), dk.float(), dv.float()


def _live(src: int, rank: int, causal: bool) -> bool:
    """Whether the block from shard `src` reaches any query of `rank`."""
    return not causal or src <= rank


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis: MeshAxis, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        n, r = axis.size, axis.coord
        o = lse = None
        kk, vv = k, v
        for hop in range(n):
            if hop:
                kk, vv = exchange([kk, vv], axis)
            src = (r - hop) % n
            if _live(src, r, causal):
                o_b, lse_b = _block_attention(q, kk, vv, scale,
                                              causal and src == r)
                o, lse = _merge(o, lse, o_b, lse_b)
        o = _finish(o, lse, q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        axis, causal, scale = ctx.axis, ctx.causal, ctx.scale
        n, r = axis.size, axis.coord
        do = do.contiguous()
        di = row_dot(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kk, vv = k, v
        for hop in range(n):
            if hop:
                kk, vv, dk, dv = exchange([kk, vv, dk, dv], axis)
            src = (r - hop) % n
            if _live(src, r, causal):
                dq_b, dk_b, dv_b = _block_grads(q, kk, vv, do, lse, di, scale,
                                                causal and src == r)
                dq += dq_b
                dk += dk_b
                dv += dv_b
        # block r + 1's grads, complete, go home; block r's arrive
        dk, dv = exchange([dk, dv], axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def ring_attention(q, k, v, *, mesh=None, axis_name: str = AXIS_SEQ,
                   causal: bool = True, scale: Optional[float] = None):
    """Exact attention with K/V rotating around `axis_name` of `mesh`.

    Per-shard function: q [B, T/n, Hq, D] and k, v [B, T/n, Hkv, D] are
    this rank's columns, rank r of the axis holding block r; returns its
    [B, T/n, Hq, D] output in q's dtype. With no mesh (or an axis of size
    1) it is one block: flash attention. Every rank of the axis must call
    it alike."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"GQA needs kv heads ({k.shape[2]}) to divide "
                         f"query heads ({q.shape[2]})")
    return _RingAttention.apply(q, k, v, mesh_axis(mesh, axis_name),
                                bool(causal), float(scale))
