"""Pipeline parallelism (counterpart of ray_tpu/parallel/pipeline.py): a
microbatched pipeline over the `pipe` axis.

The JAX pipeline is one SPMD program, a fori_loop of ticks whose
activation hand-off is a lax.ppermute, differentiated by jax AD. The
port keeps that schedule and lets autograd reverse it: n_micro +
n_stages - 1 ticks; at tick t stage 0 takes microbatch t, every stage
runs its layers on what it holds, the last stage's loss of microbatch
t - (n_stages - 1) counts where that is one, and each stage's output
goes to the next stage (parallel/sharding.ppermute, whose backward sends
the grad back). Every stage computes every tick and picks its input and
its loss term with torch.where, never a Python branch on the stage, so
every rank's graph holds the same exchanges and every rank runs their
backward in the same order (a branch would leave a received tensor out
of stage 0's graph, and its exchange's backward would never run there
while the next stage waits on it). The total is summed over `pipe`
(Megatron's g: the grad passes through, where an all-reduce would count
it pipe times) and divided by n_micro. Utilisation is n_micro / ticks,
the pipeline bubble.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils._pytree import tree_map

from ray_tpu_torch.parallel.mesh import AXIS_PIPE
from ray_tpu_torch.parallel.sharding import (MeshAxis, mesh_axis, ppermute,
                                             sum_over)


def _this_stage(a, axis: MeshAxis, n_stages: int):
    """Stage `axis.coord`'s slice of a leaf with leading dim n_stages: a
    DTensor placed Shard(0) over `pipe` gives its local [1, ...] (its
    grad keeps the placement); a plain tensor its row (its grad is then
    zero on the other stages' rows: sum it over `pipe`)."""
    if a.shape[0] != n_stages:
        raise ValueError(f"a stacked stage param has leading dim "
                         f"{a.shape[0]}, not n_stages {n_stages}")
    if isinstance(a, DTensor):
        names = a.device_mesh.mesh_dim_names
        if axis.size > 1 and a.placements[names.index(AXIS_PIPE)] != Shard(0):
            raise ValueError(f"a stacked stage param placed {a.placements} "
                             f"is not split over {AXIS_PIPE!r} on dim 0")
        return a.to_local()[0]
    return a[axis.coord]


def pipeline(stage_fn: Callable, stage_params: Any, x_micro, y_micro,
             extras: Any = None, *, axis: MeshAxis, n_stages: int,
             n_micro: int, loss_fn: Callable):
    """The pipeline's scalar objective given this stage's params only
    (make_pipeline_fn's run slices them; Transformer.pipeline_loss
    passes its local layers): the mean over microbatches of loss_fn on
    the last stage's outputs, the same on every stage."""
    if axis.size != n_stages:
        raise ValueError(f"n_stages {n_stages} must equal the {AXIS_PIPE!r} "
                         f"axis size {axis.size}")
    stage = axis.coord
    first = torch.tensor(stage == 0, device=x_micro.device)
    buf = torch.zeros_like(x_micro[0])
    total = torch.zeros((), dtype=torch.float32, device=x_micro.device)
    for t in range(n_micro + n_stages - 1):
        # stage 0 takes microbatch t (the last one again after the last:
        # its results fall past the drain window)
        inp = torch.where(first, x_micro[min(t, n_micro - 1)], buf)
        out = stage_fn(stage_params, inp)
        m = t - (n_stages - 1)
        y = y_micro[min(max(m, 0), n_micro - 1)]
        loss = loss_fn(out, y) if extras is None else loss_fn(out, y, extras)
        valid = stage == n_stages - 1 and 0 <= m < n_micro
        total = total + torch.where(torch.tensor(valid, device=total.device),
                                    loss.to(torch.float32), 0.0)
        buf = ppermute(out, axis, 1)
    return sum_over(total, axis) / n_micro


def make_pipeline_fn(stage_fn: Callable[[Any, Any], Any],
                     n_stages: int, n_micro: int, mesh,
                     loss_fn: Optional[Callable[..., Any]] = None):
    """Build run(params_stacked, x_micro, y_micro, extras=None) -> the
    mean loss over microbatches.

    stage_fn(stage_params, x) -> x' of the same shape (one stage's
    layers); params_stacked: a nested dict (or list) whose leaves have
    leading dim n_stages, each a DTensor placed Shard(0) over `pipe` (the
    "layers" -> "pipe" rule) or a plain tensor of every stage's rows;
    x_micro [n_micro, mb, ...] and y_micro [n_micro, ...] this rank's
    microbatches; loss_fn(final_out, y[, extras]) -> a scalar per
    microbatch, `extras` (e.g. the final norm and the head) passed
    through. `mesh` needs a `pipe` axis of size n_stages (or none, with
    n_stages 1); every rank of it calls run alike."""
    if loss_fn is None:
        raise ValueError("make_pipeline_fn requires loss_fn: the pipeline "
                         "returns the differentiable scalar objective")
    axis = mesh_axis(mesh, AXIS_PIPE)

    def run(params_stacked, x_micro, y_micro, extras=None):
        params = tree_map(lambda a: _this_stage(a, axis, n_stages),
                          params_stacked)
        return pipeline(stage_fn, params, x_micro, y_micro, extras,
                        axis=axis, n_stages=n_stages, n_micro=n_micro,
                        loss_fn=loss_fn)

    return run


def stack_stage_params(per_stage_params: list) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    dim (place it Shard(0) over `pipe`)."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)
