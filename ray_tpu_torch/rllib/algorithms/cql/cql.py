"""CQL: conservative Q-learning (offline RL on SAC machinery).

The port's counterpart of ray_tpu/rllib/algorithms/cql/cql.py (reference
parity: rllib/algorithms/cql/cql.py (CQLConfig — min_q_weight,
num_actions over SACConfig; offline input required; the reference's
bc_iters actor warm-up is NOT implemented here) and cql_torch_policy.py
(cql_loss: the SAC actor-critic loss plus the conservative regularizer
min_q_weight * (logsumexp_a Q(s,a) - Q(s, a_data)) estimated over
`num_actions` uniform + policy-sampled actions with importance
correction)). The regularizer joins SAC's single update on the learner's
device; its draws (the uniform candidates and the policy sample's
standard normal) are an argument of the loss like SAC's own noise, drawn
from the learner's generator on the main path. Offline fragments stream
from JsonReader shards and convert to transition tuples through DQN's
n-step/truncation-aware converter.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.dqn.dqn import fragment_to_transitions
from ray_tpu_torch.rllib.algorithms.sac.sac import SAC, SACConfig, SACLearner
from ray_tpu_torch.rllib.offline.json_io import JsonReader


class CQLConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or CQL)
        self.min_q_weight = 5.0       # conservative penalty scale
        self.num_actions = 4          # sampled actions for logsumexp
        self.input_ = None            # offline JSONL dir (required)
        # offline: no env stepping, learn every iteration
        self.num_steps_sampled_before_learning_starts = 0
        self.evaluation_interval = 0
        self.evaluation_duration = 256


class CQLLearner(SACLearner):
    """SAC's update + the conservative penalty on both critics."""

    def draw_noise(self, batch, generator) -> Tuple[torch.Tensor, ...]:
        """SAC's two draws, then the penalty's: the uniform candidates
        [num_actions, b, act_dim] over the action box and the policy
        sample's standard normal [num_actions * b, act_dim]."""
        m = self.module
        n, b = self.config.num_actions, len(batch["obs"])
        dev = batch["obs"].device
        unif = m.low_t + (m.high_t - m.low_t) * torch.rand(
            (n, b, m.act_dim), generator=generator, device=dev)
        eps = torch.randn((n * b, m.act_dim), generator=generator,
                          device=dev)
        return super().draw_noise(batch, generator) + (unif, eps)

    def compute_loss(self, batch, extra, noise: Optional[Tuple] = None):
        """`noise` (SAC's next and current draws, the uniform candidates,
        the policy sample's normal draw) defaults to draw_noise from
        extra["generator"]."""
        if noise is None:
            noise = self.draw_noise(batch, extra["generator"])
        loss, stats = super().compute_loss(batch, extra, noise[:2])
        unif, eps = noise[2], noise[3]
        m = self.module
        n = self.config.num_actions
        obs = batch["obs"]
        b = obs.shape[0]

        # candidate actions: uniform over the box + current policy
        # samples, with the standard CQL importance corrections
        rep_obs = obs.expand(n, *obs.shape).reshape(n * b, -1)
        pi_a, pi_logp = m.sample_action(rep_obs, eps)
        # the conservative penalty trains the CRITIC only (reference
        # CQL keeps separate optimizers); with the single update the
        # reparameterized policy sample must be fenced or the penalty
        # would train the actor to minimize its own Q
        pi_a = pi_a.detach().reshape(n, b, m.act_dim)
        pi_logp = pi_logp.detach().reshape(n, b)
        # log-uniform density over the box volume
        log_unif = -torch.sum(torch.log(m.high_t - m.low_t))

        def q_of(actions):
            q1, q2 = m.q_values(rep_obs, actions.reshape(n * b, -1))
            return q1.reshape(n, b), q2.reshape(n, b)

        uq1, uq2 = q_of(unif)
        pq1, pq2 = q_of(pi_a)
        cat1 = torch.cat([uq1 - log_unif, pq1 - pi_logp], dim=0)
        cat2 = torch.cat([uq2 - log_unif, pq2 - pi_logp], dim=0)
        lse1 = torch.logsumexp(cat1, dim=0) - math.log(2 * n)
        lse2 = torch.logsumexp(cat2, dim=0) - math.log(2 * n)
        dq1, dq2 = m.q_values(obs, batch["actions"])
        cql_term = torch.mean(lse1 - dq1) + torch.mean(lse2 - dq2)
        loss = loss + self.config.min_q_weight * cql_term
        stats = dict(stats)
        stats["cql_loss"] = cql_term
        return loss, stats


class CQL(SAC):
    """Offline training loop: stream recorded fragments -> transition
    tuples -> CQL update (no env sampling; reference cql.py
    training_step reads from the offline input)."""

    learner_cls = CQLLearner

    def __init__(self, config: "CQLConfig"):
        if not config.input_:
            raise ValueError(
                "CQL is an offline algorithm: point "
                "config.offline_data(input_=...) at a JsonWriter dir")
        super().__init__(config)
        self._reader = JsonReader(config.input_, seed=config.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        parts, rows = [], 0
        while rows < cfg.train_batch_size:
            frag = self._reader.next()
            tr = fragment_to_transitions(frag, cfg.gamma, cfg.n_step)
            parts.append(tr)
            rows += len(tr["obs"])
        # slice to EXACTLY train_batch_size, as the JAX package does
        # (there, to keep its compiled update's shapes fixed)
        batch = {k: np.concatenate([p[k] for p in parts])
                 [:cfg.train_batch_size] for k in parts[0]}
        rows = cfg.train_batch_size
        self._timesteps_total += rows
        stats = self.learner_group.update(
            batch, seed=cfg.seed + self._iteration)
        # polyak target update: SAC gets this from the replay loop's
        # _after_each_update hook, which this offline loop replaces
        self._after_each_update()

        if cfg.evaluation_interval and \
                self._iteration % cfg.evaluation_interval == 0:
            self.env_runners.sync_weights(
                self.learner_group.get_weights())
            frags = self.env_runners.sample_sync(
                cfg.evaluation_duration // max(1, len(self.env_runners)))
            self._record_episode_metrics(frags)
        return {"learner": stats, "num_offline_steps_trained": rows}
