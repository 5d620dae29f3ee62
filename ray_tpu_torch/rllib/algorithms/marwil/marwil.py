"""MARWIL (advantage-weighted imitation) + BC (behavior cloning).

The port's counterpart of ray_tpu/rllib/algorithms/marwil/marwil.py
(reference parity: rllib/algorithms/marwil/marwil.py (MARWILConfig —
beta exponential advantage weighting, vf_coeff, moving-average advantage
normalizer; training_step reads offline JSON input) and
rllib/algorithms/bc/bc.py (BC = MARWIL with beta=0, pure -logp
imitation)). Offline fragments are postprocessed with the same GAE used
online, then the weighted-imitation update runs on the learner's device.
With beta > 0 the value function is recomputed from the current weights
where they are, in one forward over every fragment of the iteration.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.offline.json_io import JsonReader
from ray_tpu_torch.rllib.utils.postprocessing import postprocess_fragment


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MARWIL)
        self.lr = 1e-4
        self.beta = 1.0                  # 0 => plain behavior cloning
        self.train_batch_size = 2000
        self.minibatch_size = 128
        self.num_epochs = 1
        self.moving_average_sqd_adv_norm_update_rate = 1e-2
        # periodic online evaluation with the learned policy
        self.evaluation_interval: Optional[int] = 10
        self.evaluation_duration = 400   # timesteps per eval round


class MARWILLearner(Learner):
    """exp(beta * normalized advantage)-weighted -logp + value loss
    (reference marwil_torch_policy.py marwil_loss)."""

    def compute_loss(self, batch, extra):
        out = self.module.forward_train(batch)
        dist = self.module.action_dist(out["action_dist_inputs"])
        logp = dist.logp(batch["actions"])
        cfg = self.config

        if cfg.beta > 0.0:
            # advantages arrive pre-normalized by the algorithm's moving
            # average of sqd advantages (reference keeps the same
            # normalizer in the policy)
            weights = torch.clamp(
                torch.exp(cfg.beta * batch["advantages"]), max=20.0)
            vf_loss = torch.mean((out["vf_preds"]
                                  - batch["value_targets"]) ** 2)
        else:
            weights = torch.ones_like(logp)
            vf_loss = torch.zeros((), dtype=logp.dtype, device=logp.device)

        entropy = dist.entropy()
        policy_loss = -torch.mean(weights * logp)
        loss = (policy_loss + cfg.vf_loss_coeff * vf_loss
                - cfg.entropy_coeff * torch.mean(entropy))
        return loss, {
            "policy_loss": policy_loss, "vf_loss": vf_loss,
            "entropy": torch.mean(entropy),
            "mean_imitation_weight": torch.mean(weights),
        }


class MARWIL(Algorithm):
    learner_cls = MARWILLearner

    def __init__(self, config: "MARWILConfig"):
        if not config.input_:
            raise ValueError(
                "MARWIL/BC are offline algorithms: point "
                "config.offline_data(input_=...) at a JsonWriter dir")
        super().__init__(config)
        self._reader = JsonReader(config.input_, seed=config.seed)
        self._sqd_adv_norm = 1.0  # moving average of adv^2

    def _extra_state(self) -> Dict[str, Any]:
        return {"sqd_adv_norm": self._sqd_adv_norm}

    def _restore_extra_state(self, extra: Dict[str, Any]) -> None:
        self._sqd_adv_norm = extra.get("sqd_adv_norm",
                                       self._sqd_adv_norm)

    def _with_current_values(self, frags):
        """The fragments with vf_preds and bootstrap_value recomputed from
        the CURRENT weights (reference MARWIL recomputes advantages
        against the training value function each pass, not the recorded
        behavior values): the weights do not change while a batch is
        assembled, so one forward on the learner's device covers every
        fragment's rows and last observations."""
        rows = [f["obs"].reshape((-1, *f["obs"].shape[2:])) for f in frags]
        last = [f["last_obs"] for f in frags]
        vf = np.split(self.learner_group.forward_values(
            np.concatenate(rows + last)),
            np.cumsum([len(x) for x in rows + last])[:-1])
        return [{**f, "vf_preds": v.reshape(f["rewards"].shape),
                 "bootstrap_value": b}
                for f, v, b in zip(frags, vf[:len(frags)], vf[len(frags):])]

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        # --- assemble a train batch from offline fragments -----------
        frags, rows = [], 0
        while rows < cfg.train_batch_size:
            frags.append(self._reader.next())
            rows += frags[-1]["rewards"].size
        if cfg.beta > 0.0:
            frags = self._with_current_values(frags)
        parts = [postprocess_fragment(f, cfg.gamma, cfg.lambda_)
                 for f in frags]
        batch = {k: np.concatenate([p[k] for p in parts])
                 for k in parts[0]}
        self._timesteps_total += rows

        if cfg.beta > 0.0:
            # normalize by the moving average of squared advantages
            # (reference marwil keeps the same normalizer in-policy,
            # update_averaged_estimate in marwil_torch_policy.py), in
            # f64 on the host
            raw_sqd = float(np.mean(batch["advantages"] ** 2))
            batch["advantages"] = (
                batch["advantages"]
                / max(np.sqrt(self._sqd_adv_norm), 1e-4))
            rate = cfg.moving_average_sqd_adv_norm_update_rate
            self._sqd_adv_norm = (1 - rate) * self._sqd_adv_norm \
                + rate * raw_sqd

        stats = self.learner_group.update(
            batch, minibatch_size=cfg.minibatch_size,
            num_iters=cfg.num_epochs, seed=cfg.seed + self._iteration)
        stats["sqd_adv_norm"] = self._sqd_adv_norm

        # --- periodic online evaluation ------------------------------
        if cfg.evaluation_interval and \
                self._iteration % cfg.evaluation_interval == 0:
            self.env_runners.sync_weights(
                self.learner_group.get_weights())
            frags = self.env_runners.sample_sync(
                cfg.evaluation_duration // max(1, len(self.env_runners)))
            self._record_episode_metrics(frags)

        return {"learner": stats, "num_offline_steps_trained": rows}


class BCConfig(MARWILConfig):
    """reference bc.py: BCConfig = MARWILConfig with beta forced to 0."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or BC)
        self.beta = 0.0
        self.vf_loss_coeff = 0.0


class BC(MARWIL):
    pass
