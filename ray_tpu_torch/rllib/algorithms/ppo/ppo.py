"""PPO: clipped surrogate objective with GAE.

The port's counterpart of ray_tpu/rllib/algorithms/ppo/ppo.py (reference
parity: rllib/algorithms/ppo/ppo.py:61 (PPOConfig), :397 (PPO),
training_step :423-530 — sample → GAE postprocess → standardize
advantages → LearnerGroup.update(minibatch SGD) → KL-coeff
additional_update (ppo.py:366) → sync_weights (:522-530)). Loss per
ppo_learner/ppo_torch_policy: clip surrogate + clipped VF loss +
entropy bonus + adaptive KL penalty, on tensors on the learner's device.
Multi-agent PPO sums the per-module losses into one update, with a
shared KL coefficient that adapts on the mean of the modules' KLs.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, MultiAgentLearnerMixin
from ray_tpu_torch.rllib.utils.postprocessing import (postprocess_fragment,
                                                      standardize)


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or PPO)
        self.lr = 5e-5
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.entropy_coeff = 0.0
        self.vf_loss_coeff = 1.0
        self.kl_coeff = 0.2
        self.kl_target = 0.01
        self.use_kl_loss = True
        self.num_epochs = 30
        self.minibatch_size = 128
        self.train_batch_size = 4000


class PPOLearner(Learner):
    """reference ppo_learner.py:39 + ppo.py:366 KL update."""

    def extra_inputs(self) -> Dict[str, Any]:
        return {"kl_coeff": self.curr_kl_coeff}

    def compute_loss(self, batch, extra):
        return self._module_loss(self.module, batch, extra)

    def _module_loss(self, module, batch, extra):
        out = module.forward_train(batch)
        dist = module.action_dist(out["action_dist_inputs"])
        logp = dist.logp(batch["actions"])
        logp_ratio = torch.exp(logp - batch["action_logp"])
        adv = batch["advantages"]

        clip = self.config.clip_param
        surrogate = torch.minimum(
            adv * logp_ratio,
            adv * torch.clamp(logp_ratio, 1 - clip, 1 + clip))

        # clipped value loss (reference ppo_torch_policy.py loss)
        vf = out["vf_preds"]
        vf_clip = self.config.vf_clip_param
        vf_clipped = batch["vf_preds"] + torch.clamp(
            vf - batch["vf_preds"], -vf_clip, vf_clip)
        vf_loss = torch.maximum(
            (vf - batch["value_targets"]) ** 2,
            (vf_clipped - batch["value_targets"]) ** 2)
        vf_loss = torch.clamp(vf_loss, 0, vf_clip ** 2)

        entropy = dist.entropy()
        # approximate KL(old || new) for the penalty + adaptation signal
        mean_kl = torch.mean(batch["action_logp"] - logp)

        loss = (-torch.mean(surrogate)
                + self.config.vf_loss_coeff * torch.mean(vf_loss)
                - self.config.entropy_coeff * torch.mean(entropy))
        if self.config.use_kl_loss:
            loss = loss + extra["kl_coeff"] * mean_kl

        return loss, {
            "policy_loss": -torch.mean(surrogate),
            "vf_loss": torch.mean(vf_loss),
            "entropy": torch.mean(entropy),
            "mean_kl_loss": mean_kl,
        }

    def additional_update(self, *, mean_kl: float) -> Dict[str, Any]:
        """Adaptive KL coefficient (reference ppo.py:366
        update_kl / ppo_learner additional_update_for_module)."""
        if mean_kl > 2.0 * self.config.kl_target:
            self.curr_kl_coeff *= 1.5
        elif mean_kl < 0.5 * self.config.kl_target:
            self.curr_kl_coeff *= 0.5
        return {"curr_kl_coeff": self.curr_kl_coeff}


class MultiAgentPPOLearner(MultiAgentLearnerMixin, PPOLearner):
    """Per-module PPO losses summed into one update (reference
    marl_module.py:40 + learner.py compute_loss over a MultiAgentBatch).
    The KL coefficient adapts on the cross-module mean (shared
    coefficient; per-module KLs are reported individually)."""

    def compute_loss(self, batch, extra):
        total = 0.0
        stats: Dict[str, Any] = {}
        kls = []
        for mid in self.module.module_ids:
            loss_m, st = self._module_loss(self.module[mid], batch[mid],
                                           extra)
            total = total + loss_m
            kls.append(st["mean_kl_loss"])
            for k, v in st.items():
                stats[f"{mid}/{k}"] = v
        stats["mean_kl_loss"] = sum(kls) / len(kls)
        return total, stats


class PPO(Algorithm):
    learner_cls = PPOLearner
    ma_learner_cls = MultiAgentPPOLearner

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        # --- sample phase (ppo.py:428-460) ---------------------------
        per_runner = max(
            cfg.rollout_fragment_length * cfg.num_envs_per_env_runner,
            cfg.train_batch_size // len(self.env_runners))
        fragments = self.env_runners.sample_sync(per_runner)
        self._record_episode_metrics(fragments)

        processed = [postprocess_fragment(f, cfg.gamma, cfg.lambda_)
                     for f in fragments]
        if cfg.policies:
            # MultiAgentBatch: split flat rows by the lane→module routing
            # ([T, N] flatten means row t*N+lane, so the per-row module
            # is lane_module tiled T times); advantages standardize
            # per module (each module is its own optimization problem).
            parts: Dict[str, list] = {}
            for f, p in zip(fragments, processed):
                t_len = f["actions"].shape[0]
                order = f["module_order"]
                row_mod = np.tile(f["lane_module"], t_len)
                for i, mid in enumerate(order):
                    rows = row_mod == i
                    parts.setdefault(mid, []).append(
                        {k: v[rows] for k, v in p.items()})
            batch = {mid: {k: np.concatenate([pp[k] for pp in ps])
                           for k in ps[0]}
                     for mid, ps in parts.items()}
            n_rows = sum(len(b["obs"]) for b in batch.values())
            self._timesteps_total += n_rows
            for b in batch.values():
                b["advantages"] = standardize(b["advantages"])
            stats = self.learner_group.update(
                batch, minibatch_size=cfg.minibatch_size,
                num_iters=cfg.num_epochs, seed=cfg.seed + self._iteration)
            extra = self.learner_group.additional_update(
                mean_kl=stats.get("mean_kl_loss", 0.0))
            stats.update(extra)
            self.env_runners.sync_weights(
                self.learner_group.get_weights())
            return {"learner": stats, "num_env_steps_trained": n_rows}
        batch = {k: np.concatenate([p[k] for p in processed])
                 for k in processed[0]}
        self._timesteps_total += len(batch["obs"])
        batch["advantages"] = standardize(batch["advantages"])

        # --- learn phase (ppo.py:487-491) ----------------------------
        stats = self.learner_group.update(
            batch, minibatch_size=cfg.minibatch_size,
            num_iters=cfg.num_epochs, seed=cfg.seed + self._iteration)

        # --- additional updates (KL coeff, ppo.py:366) ---------------
        extra = self.learner_group.additional_update(
            mean_kl=stats.get("mean_kl_loss", 0.0))
        stats.update(extra)

        # --- sync phase (ppo.py:522-530) -----------------------------
        self.env_runners.sync_weights(self.learner_group.get_weights())
        return {"learner": stats,
                "num_env_steps_trained": len(batch["obs"])}
