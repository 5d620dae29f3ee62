"""V-trace off-policy correction (Espeholt et al. 2018), in PyTorch.

The port's counterpart of ray_tpu/rllib/algorithms/impala/vtrace.py
(reference parity: rllib/algorithms/impala/vtrace_torch.py:251
(from_importance_weights)). Time-major [T, B] tensors; the backward
recursion is a reverse Python loop over T in place of the JAX package's
`lax.scan(reverse=True)`, and the whole function runs under
torch.no_grad(), as the JAX package stops the gradient of both outputs.
It computes in the inputs' dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor             # [T, B] value targets
    pg_advantages: torch.Tensor  # [T, B] policy-gradient advantages


@torch.no_grad()
def from_importance_weights(log_rhos, discounts, rewards, values,
                            bootstrap_value,
                            clip_rho_threshold: float = 1.0,
                            clip_pg_rho_threshold: float = 1.0
                            ) -> VTraceReturns:
    """All inputs time-major [T, B]; bootstrap_value [B].

    discounts must already include termination masking
    (gamma * (1 - done)).
    """
    rhos = torch.exp(log_rhos)
    clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold)
    cs = torch.clamp(rhos, max=1.0)

    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (
        rewards + discounts * values_t_plus_1 - values)

    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values

    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = torch.clamp(rhos, max=clip_pg_rho_threshold)
    pg_advantages = clipped_pg_rhos * (
        rewards + discounts * vs_t_plus_1 - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
