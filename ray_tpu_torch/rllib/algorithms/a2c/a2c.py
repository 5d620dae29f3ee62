"""A2C: synchronous advantage actor-critic.

reference parity: rllib/algorithms/a2c/a2c.py (A2CConfig over
PPOConfig's on-policy plumbing: microbatch_size accumulating gradients
toward train_batch_size; loss = policy gradient with GAE advantages +
value loss + entropy, a2c_torch_policy.py). Distinctions from PG here: fragment-boundary
bootstrapping through GAE (PG uses whole-episode Monte-Carlo shaped
rollouts; lambda is configurable — lower it below 1.0 for the
bias/variance trade the reference's n-step returns provide) and
microbatched updates — this build maps microbatch_size onto the
learner's minibatch loop (per-microbatch Adam steps rather than the
reference's gradient accumulation; at A2C's single-epoch on-policy
regime the two are equivalent up to Adam's step-size normalization).
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.pg.pg import PGLearner
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig


class A2CConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or A2C)
        self.lr = 1e-3
        self.train_batch_size = 1000
        self.microbatch_size = None   # None -> one full-batch pass
        self.minibatch_size = None    # override PPO's 128 default —
        # None means the learner takes ONE full-batch step
        self.num_epochs = 1
        self.lambda_ = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.use_kl_loss = False

    def training(self, *, microbatch_size=None, **kwargs):
        if microbatch_size is not None:
            self.microbatch_size = int(microbatch_size)
        return super().training(**kwargs)


class A2CLearner(PGLearner):
    """Same actor-critic loss as PG (no clip/KL); A2C's identity is the
    sync sample->update loop + bootstrapped advantages."""


class A2C(PPO):
    learner_cls = A2CLearner

    def training_step(self):
        # map microbatch_size onto the minibatch loop for this step
        cfg = self.config
        if cfg.microbatch_size is not None:
            cfg.minibatch_size = cfg.microbatch_size
        return super().training_step()
