"""PolyakTargetLearner: shared target-network scaffolding.

The port's counterpart of ray_tpu/rllib/core/target_learner.py. SAC and
TD3 both keep polyak-averaged target copies of (a subtree of) their
params, draw their loss's noise from the learner's own generator, and
carry targets through checkpoints; this base holds that once (the
reference keeps the equivalent in each policy class). The target is a
frozen copy of the module's groups on the learner's device, and the
polyak step is two foreach ops there: no host sync.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ray_tpu_torch.rllib.core.learner import Learner, _to_numpy, _to_torch


class PolyakTargetLearner(Learner):
    """Subclasses set `target_keys` (None = the whole module) and read
    extra["target"] (the frozen copy, whose groups are attributes as the
    module's are) and extra["generator"] in compute_loss; the owning
    algorithm calls additional_update(polyak=True) after each gradient
    step."""

    target_keys: Optional[List[str]] = None
    rng_salt: int = 0

    def build(self, seed: int = 0) -> None:
        super().build(seed)
        self._post_build(seed)

    def _target_source(self) -> List[nn.Parameter]:
        if self.target_keys is None:
            return list(self.module.parameters())
        return [p for k in self.target_keys
                for p in getattr(self.module, k).parameters()]

    def _post_build(self, seed: int) -> None:
        with self._state_lock:
            if self.target_keys is None:
                target = copy.deepcopy(self.module)
            else:
                target = nn.ModuleDict(
                    {k: copy.deepcopy(getattr(self.module, k))
                     for k in self.target_keys})
            self._target = target.requires_grad_(False)
        self._gen = torch.Generator(device=self.device).manual_seed(
            seed + self.rng_salt)

    def extra_inputs(self) -> Dict[str, Any]:
        return {"target": self._target, "generator": self._gen}

    def additional_update(self, *, polyak: bool = True,
                          **kw) -> Dict[str, Any]:
        """Polyak target update (1 - tau) t + tau p; also absorbs the
        base replay loop's periodic update_target=True (a hard sync would
        fight tau-averaging)."""
        if polyak:
            tau = self.config.tau
            with self._state_lock, torch.no_grad():
                target = list(self._target.parameters())
                torch._foreach_mul_(target, 1.0 - tau)
                torch._foreach_add_(target, self._target_source(),
                                    alpha=tau)
        return {}

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        with self._state_lock:
            state["target"] = _to_numpy(dict(self._target.state_dict()))
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        with self._state_lock:
            self._target.load_state_dict(_to_torch(state["target"]))


class ContinuousReplayAlgoMixin:
    """Algorithm-side hooks shared by SAC/TD3 over DQN's replay loop:
    no epsilon push by default (these policies explore their own way —
    TD3 overrides _before_sample to push its noise scale instead), one
    gradient step per sampled env step by default, polyak after every
    update instead of periodic hard target syncs."""

    def _before_sample(self, stats: Dict[str, Any]) -> None:
        pass  # no epsilon; stochastic/noise exploration is in-policy

    def _training_intensity(self) -> float:
        cfg = self.config
        return (cfg.training_intensity
                if cfg.training_intensity is not None
                else float(cfg.train_batch_size))

    def _after_each_update(self) -> None:
        self.learner_group.additional_update(polyak=True)

    def _maybe_update_target(self) -> None:
        pass  # polyak per update replaces periodic hard syncs
