"""Ulysses sequence parallelism (counterpart of
ray_tpu/parallel/ulysses.py): all-to-all head/sequence resharding.

Outside attention, activations are split over the `seq` axis. For
attention an all-to-all turns the sequence split into a head split, so
each rank attends the whole sequence with its own heads, and a second
all-to-all turns it back (parallel/sharding.all_to_all, over
all_to_all_single). The local attention is `inner`, by default the
port's flash attention: the hand-written kernels on CUDA, their plain
versions on the CPU (the JAX module's dense default would hold
[B, H/n, T, T] f32 scores at long T).
"""

from __future__ import annotations

from typing import Callable, Optional

from ray_tpu_torch.ops.attention import _repeat_kv, flash_attention
from ray_tpu_torch.parallel.mesh import AXIS_SEQ
from ray_tpu_torch.parallel.sharding import all_to_all, mesh_axis


def _default_inner(q, k, v, causal, scale):
    # q, k, v: [B, T, h_local, D] with the whole sequence locally
    return flash_attention(q, k, v, causal=causal, scale=scale)


def ulysses_attention(q, k, v, *, mesh=None, axis_name: str = AXIS_SEQ,
                      causal: bool = True, scale: Optional[float] = None,
                      inner: Optional[Callable] = None):
    """Per-shard attention with all-to-all head<->seq resharding over
    `axis_name` of `mesh`.

    q/k/v are this rank's [batch, seq_local, heads, head_dim]; heads must
    divide by the axis size. `inner(q, k, v, causal, scale)` is the local
    attention on [B, T, heads/n, D] (default: flash attention). Every
    rank of the axis must call it alike."""
    axis = mesh_axis(mesh, axis_name)
    sp = axis.size
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.shape[2] % sp != 0:
        raise ValueError(
            f"heads ({q.shape[2]}) must be divisible by seq-parallel size "
            f"{sp}; use ring_attention for head counts below the seq axis "
            f"size")
    if k.shape[2] != q.shape[2] and k.shape[2] % sp != 0:
        # GQA with kv heads not divisible by the seq axis: widen K/V to
        # the query heads before the all-to-all (the divisible case moves
        # only the true kv heads)
        k, v = _repeat_kv(k, q.shape[2]), _repeat_kv(v, q.shape[2])

    # [B, T/sp, H, D] -> [B, T, H/sp, D]: split heads, gather the sequence
    qh, kh, vh = (all_to_all(x, axis, 2, 1) for x in (q, k, v))
    oh = (inner or _default_inner)(qh, kh, vh, causal, scale)
    return all_to_all(oh, axis, 1, 2).to(q.dtype)
