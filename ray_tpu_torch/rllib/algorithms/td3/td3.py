"""TD3: twin-delayed deep deterministic policy gradient.

The port's counterpart of ray_tpu/rllib/algorithms/td3/td3.py (reference
parity: rllib/algorithms/td3/td3.py (TD3Config — twin Q, target policy
smoothing with clipped noise, delayed policy updates, gaussian
exploration; built on the DDPG policy ddpg_torch_policy.py)). As in SAC,
critic and (gated) actor losses sum into one update; the policy-delay
gate comes from extra_inputs and drops the actor's update on gated steps
(postprocess_updates) while Adam's moments still advance; targets
(policy + twin Q) polyak-update on the device. The exploration noise
scale reaches the runner's forward in the batch, like DQN's epsilon.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.sac.sac import BoxActorCritic
from ray_tpu_torch.rllib.core.catalog import _he_init, _mlp, _mlp_apply
from ray_tpu_torch.rllib.core.target_learner import (ContinuousReplayAlgoMixin,
                                                     PolyakTargetLearner)


class TD3Config(DQNConfig):
    """Shares DQN's replay-loop knobs; DQN-only knobs (dueling,
    double_q, epsilon_*) are inert."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or TD3)
        self.lr = 1e-3
        self.train_batch_size = 100
        self.rollout_fragment_length = 1
        self.tau = 0.005
        self.policy_delay = 2
        self.target_noise = 0.2          # smoothing noise stddev
        self.target_noise_clip = 0.5
        self.exploration_noise = 0.1     # of the action range
        self.num_steps_sampled_before_learning_starts = 1500
        self.initial_epsilon = self.final_epsilon = 0.0


class DeterministicModule(BoxActorCritic):
    """mu(s) policy + twin Q(s, a) critics (reference
    ddpg_torch_model.py). Exploration adds gaussian action noise scaled
    by batch["noise_scale"] (put there by the runner)."""

    def __init__(self, obs_dim: int, act_dim: int, low, high,
                 hiddens: Sequence[int] = (256, 256)):
        super().__init__()
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hiddens = tuple(hiddens)
        self._set_bounds(low, high)
        self.pi = _mlp([obs_dim, *self.hiddens, act_dim])
        self.q1 = _mlp([obs_dim + act_dim, *self.hiddens, 1])
        self.q2 = _mlp([obs_dim + act_dim, *self.hiddens, 1])
        self.init_params(0)

    def init_params(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        _he_init(self.pi, gen, scale_last=0.01)
        _he_init(self.q1, gen, scale_last=1.0)
        _he_init(self.q2, gen, scale_last=1.0)

    def mu(self, obs, nets=None):
        nets = self if nets is None else nets
        x = _mlp_apply(nets.pi, obs.to(self.scale.dtype))
        return torch.tanh(x) * self.scale + self.mid

    def forward_train(self, batch):
        a = self.mu(batch["obs"])
        return {"action_dist_inputs": a,
                "vf_preds": torch.zeros(a.shape[:-1], device=a.device)}

    def forward_exploration(self, batch, generator):
        out = self.forward_train(batch)
        a = out["action_dist_inputs"]
        noise_scale = batch.get("noise_scale", 0.0)
        noise = torch.randn(a.shape, generator=generator,
                            device=a.device) * self.scale * noise_scale
        out["actions"] = torch.clamp(a + noise, self.low_t, self.high_t)
        out["action_logp"] = torch.zeros(a.shape[:-1], device=a.device)
        return out

    def forward_inference(self, batch):
        out = self.forward_train(batch)
        out["actions"] = out["action_dist_inputs"]
        return out


class TD3Learner(PolyakTargetLearner):
    """One update: twin-critic TD loss against a smoothed target action,
    plus the deterministic policy-gradient term gated by the policy-delay
    scalar (reference ddpg_torch_policy.py build_ddpg_losses + TD3's
    smoothing/delay). Target scaffolding comes from PolyakTargetLearner
    (the whole module)."""

    target_keys = None  # target the full module: pi + q1 + q2
    rng_salt = 311

    def _post_build(self, seed: int) -> None:
        super()._post_build(seed)
        self._updates = 0

    def extra_inputs(self) -> Dict[str, Any]:
        extra = super().extra_inputs()
        self._updates += 1
        extra["policy_gate"] = \
            1.0 if self._updates % self.config.policy_delay == 0 else 0.0
        return extra

    def postprocess_updates(self, extra) -> Tuple[str, ...]:
        """Actor params move ONLY on delayed steps (TD3's invariant) —
        zeroing the loss alone would leave Adam momentum walking the
        policy every step. As in the JAX package (a deliberate deviation
        from the reference's separate actor optimizer), the shared Adam's
        pi moments still advance during gated steps."""
        return () if extra["policy_gate"] else ("pi",)

    def draw_noise(self, batch, generator) -> torch.Tensor:
        """The loss's standard-normal draw for the smoothing noise."""
        return torch.randn((len(batch["obs"]), self.module.act_dim),
                           generator=generator, device=batch["obs"].device)

    def compute_loss(self, batch, extra,
                     noise: Optional[torch.Tensor] = None):
        """`noise` (the smoothing draw) defaults to a draw from
        extra["generator"]."""
        m: DeterministicModule = self.module
        cfg = self.config
        if noise is None:
            noise = self.draw_noise(batch, extra["generator"])

        # ---- smoothed target action (TD3's trick #3) ----------------
        with torch.no_grad():
            a_next = m.mu(batch["next_obs"], nets=extra["target"])
            clip = cfg.target_noise_clip * m.scale
            smooth = torch.clamp(noise * cfg.target_noise * m.scale,
                                 -clip, clip)
            a_next = torch.clamp(a_next + smooth, m.low_t, m.high_t)
            tq1, tq2 = m.q_values(batch["next_obs"], a_next,
                                  nets=extra["target"])
            target = batch["rewards"] + batch["discounts"] \
                * (1.0 - batch["dones"]) * torch.minimum(tq1, tq2)

        q1, q2 = m.q_values(batch["obs"], batch["actions"])
        w = batch.get("weights")
        td_sq = 0.5 * ((q1 - target) ** 2 + (q2 - target) ** 2)
        critic_loss = torch.mean(td_sq * w) if w is not None \
            else torch.mean(td_sq)

        # ---- delayed deterministic policy gradient ------------------
        pi_a = m.mu(batch["obs"])
        q_pi, _ = m.q_values(batch["obs"], pi_a, detach=True)
        actor_loss = -torch.mean(q_pi)

        loss = critic_loss + extra["policy_gate"] * actor_loss
        stats = {"critic_loss": critic_loss, "actor_loss": actor_loss,
                 "mean_q": torch.mean(torch.minimum(q1, q2)),
                 "td_error": 0.5 * ((q1 - target).abs()
                                    + (q2 - target).abs())}
        if "batch_indexes" in batch:
            stats["td_indexes"] = batch["batch_indexes"]
        return loss, stats

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["updates"] = self._updates
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        self._updates = state.get("updates", self._updates)


class TD3(ContinuousReplayAlgoMixin, DQN):
    """DQN's replay loop with TD3 hooks: gaussian action noise instead
    of epsilon, polyak targets after every update."""

    learner_cls = TD3Learner

    def default_module(self, observation_space, action_space):
        if len(observation_space.shape) != 1 or \
                not hasattr(action_space, "low"):
            raise NotImplementedError(
                f"TD3 ships a deterministic MLP for 1-D obs and Box "
                f"actions; got obs={observation_space} "
                f"act={action_space}.")
        return DeterministicModule(
            observation_space.shape[0], action_space.shape[0],
            action_space.low, action_space.high,
            self.config.model_hiddens)

    def _before_sample(self, stats: Dict[str, Any]) -> None:
        self.env_runners.set_explore_inputs(
            {"noise_scale": self.config.exploration_noise})
        stats["exploration_noise"] = self.config.exploration_noise
