"""Advantage estimation (GAE), jax + numpy.

reference parity: rllib/evaluation/postprocessing.py:89
(compute_advantages) / :158 (compute_gae_for_sample_batch).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def compute_gae(rewards: np.ndarray, values: np.ndarray,
                dones: np.ndarray, bootstrap_value: np.ndarray,
                gamma: float, lambda_: float):
    """GAE over a fragment batch [T, N]; returns (advantages,
    value_targets), both [T, N]. `dones` marks episode ends (truncation
    bootstrap already folded into rewards by the runner)."""
    t_len = rewards.shape[0]
    adv = np.zeros_like(rewards)
    last = np.zeros_like(bootstrap_value)
    next_values = bootstrap_value
    for t in range(t_len - 1, -1, -1):
        not_done = 1.0 - dones[t].astype(rewards.dtype)
        delta = rewards[t] + gamma * next_values * not_done - values[t]
        last = delta + gamma * lambda_ * not_done * last
        adv[t] = last
        next_values = values[t]
    return adv, adv + values


def postprocess_fragment(batch: Dict[str, Any], gamma: float,
                         lambda_: float) -> Dict[str, np.ndarray]:
    """Fragment [T, N, ...] -> flat transition batch with advantages +
    value targets (reference compute_gae_for_sample_batch)."""
    dones = batch["terminateds"] | batch["truncateds"]
    adv, targets = compute_gae(
        batch["rewards"], batch["vf_preds"], dones,
        batch["bootstrap_value"], gamma, lambda_)

    def flat(x):
        return np.reshape(x, (-1,) + x.shape[2:])

    return {
        "obs": flat(batch["obs"]),
        "actions": flat(batch["actions"]),
        "action_logp": flat(batch["action_logp"]),
        "vf_preds": flat(batch["vf_preds"]),
        "advantages": flat(adv),
        "value_targets": flat(targets),
    }


def standardize(x: np.ndarray) -> np.ndarray:
    """reference rollout_ops standardize_fields on advantages."""
    return (x - x.mean()) / max(1e-4, x.std())
