"""PG: vanilla policy gradient (REINFORCE with a value baseline).

The port's counterpart of ray_tpu/rllib/algorithms/pg/pg.py (reference
parity: rllib/algorithms/pg/pg.py + pg_torch_policy.py — loss =
-mean(logp(a) * advantage), one pass per batch, no clipping or KL
machinery; advantages come from the standard GAE postprocessing
(lambda=1 gives pure Monte-Carlo returns-to-go minus baseline)). The
simplest on-policy baseline in the registry, useful as a correctness
reference for the fancier algorithms.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.core.learner import Learner


class PGConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or PG)
        self.lr = 4e-3
        self.train_batch_size = 2000
        self.minibatch_size = None   # single full-batch pass
        self.num_epochs = 1
        self.lambda_ = 1.0           # Monte-Carlo returns-to-go
        self.use_kl_loss = False     # PPO-only machinery, inert here


class PGLearner(Learner):
    def compute_loss(self, batch, extra):
        out = self.module.forward_train(batch)
        dist = self.module.action_dist(out["action_dist_inputs"])
        logp = dist.logp(batch["actions"])
        policy_loss = -torch.mean(logp * batch["advantages"])
        vf_loss = torch.mean((out["vf_preds"] - batch["value_targets"]) ** 2)
        entropy = torch.mean(dist.entropy())
        loss = (policy_loss
                + self.config.vf_loss_coeff * vf_loss
                - self.config.entropy_coeff * entropy)
        return loss, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                      "entropy": entropy}


class PG(PPO):
    """Reuses PPO's on-policy training_step verbatim (sample →
    postprocess → standardize → update → sync); the KL additional_update
    no-ops because PGLearner inherits the base's empty
    additional_update."""

    learner_cls = PGLearner
