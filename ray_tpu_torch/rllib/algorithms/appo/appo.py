"""APPO: asynchronous PPO — IMPALA's pipeline with PPO's clipped loss.

The port's counterpart of ray_tpu/rllib/algorithms/appo/appo.py
(reference parity: rllib/algorithms/appo/appo.py — APPO subclasses Impala
(the async sampling architecture, learner thread, broadcast machinery
are shared) and swaps the learner for a clipped-surrogate objective
whose advantages come from V-trace (appo_torch_policy / APPOLearner)).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.impala.impala import (Impala,
                                                          ImpalaConfig,
                                                          ImpalaLearner)


class APPOConfig(ImpalaConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or APPO)
        self.clip_param = 0.3
        # APPO defaults differ from IMPALA's (reference appo.py):
        self.lr = 3e-4
        self.entropy_coeff = 0.005


class APPOLearner(ImpalaLearner):
    """PPO clipped surrogate over V-trace advantages (reference
    appo_torch_policy.py loss: ratio clamped to [1-eps, 1+eps] against
    vtrace pg_advantages, value targets = vtrace vs)."""

    def compute_loss(self, batch, extra):
        dist, _target_logp, log_rhos, values, vtrace = \
            self._vtrace_prelude(batch)
        ratio = torch.exp(log_rhos)
        eps = self.config.clip_param
        adv = vtrace.pg_advantages
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv)
        pg_loss = -torch.mean(surrogate)
        vf_loss = 0.5 * torch.mean((vtrace.vs - values) ** 2)
        entropy = torch.mean(dist.entropy())
        loss = (pg_loss + self.config.vf_loss_coeff * vf_loss
                - self.config.entropy_coeff * entropy)
        return loss, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                      "entropy": entropy,
                      "mean_ratio": torch.mean(ratio)}


class APPO(Impala):
    learner_cls = APPOLearner
