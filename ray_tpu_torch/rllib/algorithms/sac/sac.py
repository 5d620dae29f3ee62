"""SAC: soft actor-critic for continuous control.

The port's counterpart of ray_tpu/rllib/algorithms/sac/sac.py (reference
parity: rllib/algorithms/sac/sac.py (SACConfig — twin Q, tau polyak
target update, initial_alpha/target_entropy="auto", n_step replay;
training_step shares the DQN replay loop) and sac_torch_policy.py
(actor_critic_loss: squashed-gaussian policy, min-of-twin-Q targets with
entropy bonus, trainable log_alpha against target entropy)). Actor,
critic and alpha losses sum into one loss under one Adam, with each
term's gradient routed to its own params (the critic target under
no_grad, the actor's Q through detached params, the alpha term through a
detached log-prob), as the JAX package's stop_gradients route them; the
targets polyak-update on the device after each update.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.core.catalog import _he_init, _mlp, _mlp_apply
from ray_tpu_torch.rllib.core.rl_module import RLModule
from ray_tpu_torch.rllib.core.target_learner import (ContinuousReplayAlgoMixin,
                                                     PolyakTargetLearner)

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class SACConfig(DQNConfig):
    """Shares DQN's replay-loop knobs (buffer_size, n_step,
    prioritized_replay*, training_intensity, learning-start threshold).
    DQN-only knobs (dueling, double_q, epsilon_*,
    target_network_update_freq) are inert: SAC's stochastic policy
    explores and its targets polyak-update every gradient step (tau)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or SAC)
        self.lr = 3e-4
        self.train_batch_size = 256
        self.rollout_fragment_length = 1
        self.tau = 0.005
        self.initial_alpha = 1.0
        self.target_entropy = "auto"     # -> -action_dim
        self.num_steps_sampled_before_learning_starts = 1500
        # epsilon schedule is inert for SAC (stochastic policy explores)
        self.initial_epsilon = self.final_epsilon = 0.0


class BoxActorCritic(RLModule):
    """The part SAC's and TD3's modules share: actions rescale from
    [-1, 1] to a Box's [low, high] (the scale, midpoint and bounds are
    non-persistent buffers, so they move with the module and stay out of
    its weights), and twin Q(s, a) critics q1 and q2."""

    def _set_bounds(self, low, high) -> None:
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)
        for name, value in (("scale", (self.high - self.low) / 2.0),
                            ("mid", (self.high + self.low) / 2.0),
                            ("low_t", self.low), ("high_t", self.high)):
            self.register_buffer(name, torch.from_numpy(np.array(value)),
                                 persistent=False)

    def q_values(self, obs, actions, nets=None, detach: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Twin Q(s, a) through `nets`' q1 and q2 (the module's own, or a
        target copy's); with `detach` the Q params take no gradient."""
        nets = self if nets is None else nets
        dtype = self.scale.dtype   # the params' (f32, or f64 in a check)
        x = torch.cat([obs.to(dtype), actions.to(dtype)], dim=-1)
        return (_mlp_apply(nets.q1, x, detach)[..., 0],
                _mlp_apply(nets.q2, x, detach)[..., 0])


class SquashedGaussianModule(BoxActorCritic):
    """tanh-squashed gaussian policy + twin Q(s, a) critics (reference
    sac_torch_model.py). Actions rescale to [low, high]. The module holds
    SAC's trainable log_alpha too (the JAX learner adds it to its params
    pytree after build, and the runners' weights carry it unused there as
    well); the learner sets its value from the config."""

    def __init__(self, obs_dim: int, act_dim: int, low, high,
                 hiddens: Sequence[int] = (256, 256)):
        super().__init__()
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hiddens = tuple(hiddens)
        self._set_bounds(low, high)
        self.pi = _mlp([obs_dim, *self.hiddens, 2 * act_dim])
        self.q1 = _mlp([obs_dim + act_dim, *self.hiddens, 1])
        self.q2 = _mlp([obs_dim + act_dim, *self.hiddens, 1])
        self.log_alpha = nn.Parameter(torch.zeros(()))
        self.init_params(0)

    def init_params(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        _he_init(self.pi, gen, scale_last=0.01)
        _he_init(self.q1, gen, scale_last=1.0)
        _he_init(self.q2, gen, scale_last=1.0)
        with torch.no_grad():
            self.log_alpha.zero_()

    # ---- pure heads -------------------------------------------------
    def pi_dist_inputs(self, obs):
        out = _mlp_apply(self.pi, obs.to(self.scale.dtype))
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def squash(self, mean, log_std, noise):
        """Reparameterized squashed sample from the policy's gaussian and
        standard-normal `noise` of its shape -> (action, logp)."""
        std = torch.exp(log_std)
        u = mean + std * noise
        logp_u = torch.sum(
            -0.5 * (((u - mean) / std) ** 2 + 2 * log_std
                    + math.log(2 * math.pi)), dim=-1)
        t = torch.tanh(u)
        action = t * self.scale + self.mid
        logp = logp_u - torch.sum(
            torch.log(self.scale * (1 - t ** 2) + 1e-6), dim=-1)
        return action, logp

    def sample_action(self, obs, noise):
        return self.squash(*self.pi_dist_inputs(obs), noise)

    # ---- RLModule contract ------------------------------------------
    def forward_train(self, batch):
        mean, log_std = self.pi_dist_inputs(batch["obs"])
        return {"action_dist_inputs": torch.cat([mean, log_std], dim=-1),
                # replay path bootstraps at update time; no V head
                "vf_preds": torch.zeros(mean.shape[:-1],
                                        device=mean.device)}

    def forward_exploration(self, batch, generator):
        mean, log_std = self.pi_dist_inputs(batch["obs"])
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device)
        actions, logp = self.squash(mean, log_std, noise)
        return {"action_dist_inputs": torch.cat([mean, log_std], dim=-1),
                "vf_preds": torch.zeros(mean.shape[:-1],
                                        device=mean.device),
                "actions": actions, "action_logp": logp}

    def forward_inference(self, batch):
        out = self.forward_train(batch)
        mean, _ = self.pi_dist_inputs(batch["obs"])
        out["actions"] = torch.tanh(mean) * self.scale + self.mid
        return out


class SACLearner(PolyakTargetLearner):
    """One update for critic + actor + alpha (reference
    sac_torch_policy.py actor_critic_loss + optimizer_fn's three Adams).
    Target scaffolding (polyak, noise generator, checkpointing) comes
    from PolyakTargetLearner."""

    target_keys = ["q1", "q2"]
    rng_salt = 777

    def _post_build(self, seed: int) -> None:
        with self._state_lock, torch.no_grad():
            self.module.log_alpha.fill_(
                float(np.log(self.config.initial_alpha)))
        super()._post_build(seed)
        act_dim = self.module.act_dim
        self.target_entropy = (-float(act_dim)
                               if self.config.target_entropy == "auto"
                               else float(self.config.target_entropy))

    def draw_noise(self, batch, generator) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """The loss's two standard-normal draws, for the next and the
        current observations' actions, in that order."""
        shape = (len(batch["obs"]), self.module.act_dim)
        return tuple(torch.randn(shape, generator=generator,
                                 device=batch["obs"].device)
                     for _ in range(2))

    def compute_loss(self, batch, extra, noise: Optional[Tuple] = None):
        """`noise` (the next and the current draw) defaults to draws from
        extra["generator"]."""
        m: SquashedGaussianModule = self.module
        eps_next, eps_pi = noise if noise is not None else \
            self.draw_noise(batch, extra["generator"])
        alpha = torch.exp(m.log_alpha)

        # ---- critic target: r + gamma^n (1-d) (minQ' - a*logp') -----
        with torch.no_grad():
            next_a, next_logp = m.sample_action(batch["next_obs"], eps_next)
            tq1, tq2 = m.q_values(batch["next_obs"], next_a,
                                  nets=extra["target"])
            q_next = torch.minimum(tq1, tq2) - alpha * next_logp
            target = batch["rewards"] + batch["discounts"] * \
                (1.0 - batch["dones"]) * q_next
        q1, q2 = m.q_values(batch["obs"], batch["actions"])
        # per-sample importance weights when prioritized replay is on
        w = batch.get("weights")
        td_sq = 0.5 * ((q1 - target) ** 2 + (q2 - target) ** 2)
        critic_loss = torch.mean(td_sq * w) if w is not None \
            else torch.mean(td_sq)

        # ---- actor: alpha*logp - minQ(s, a~pi), Q params frozen -----
        pi_a, pi_logp = m.sample_action(batch["obs"], eps_pi)
        pq1, pq2 = m.q_values(batch["obs"], pi_a, detach=True)
        actor_loss = torch.mean(
            alpha.detach() * pi_logp - torch.minimum(pq1, pq2))

        # ---- alpha: match target entropy ----------------------------
        alpha_loss = -torch.mean(
            m.log_alpha * (pi_logp + self.target_entropy).detach())

        loss = critic_loss + actor_loss + alpha_loss
        stats = {
            "critic_loss": critic_loss, "actor_loss": actor_loss,
            "alpha_loss": alpha_loss, "alpha": alpha,
            "mean_q": torch.mean(torch.minimum(q1, q2)),
            "entropy": -torch.mean(pi_logp),
            # new priorities: mean abs TD over the twin critics
            # (reference sac_torch_policy td_error output)
            "td_error": 0.5 * ((q1 - target).abs()
                               + (q2 - target).abs()),
        }
        if "batch_indexes" in batch:
            stats["td_indexes"] = batch["batch_indexes"]
        return loss, stats


class SAC(ContinuousReplayAlgoMixin, DQN):
    """Runs DQN's shared replay loop with the continuous-control hooks
    (one gradient step per env step, polyak targets every update;
    reference SAC extends DQN the same way, sac.py)."""

    learner_cls = SACLearner

    def default_module(self, observation_space, action_space):
        if len(observation_space.shape) != 1 or \
                not hasattr(action_space, "low"):
            raise NotImplementedError(
                f"SAC ships a squashed-gaussian MLP for 1-D obs and Box "
                f"actions; got obs={observation_space} "
                f"act={action_space}. Pass a custom module via "
                f"config.rl_module(module=...).")
        hiddens = self.config.model_hiddens
        return SquashedGaussianModule(
            observation_space.shape[0], action_space.shape[0],
            action_space.low, action_space.high, hiddens)
