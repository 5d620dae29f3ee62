"""Exploration noise processes beyond epsilon-greedy/gaussian.

The port's counterpart of ray_tpu/rllib/utils/exploration.py (reference
parity: rllib/utils/exploration/ — ornstein_uhlenbeck_noise.py
(temporally-correlated action noise for continuous control) and
parameter_noise.py (Plappert et al. adaptive param-space noise: perturb
the policy WEIGHTS per episode, adapt sigma so the induced action
divergence tracks a target). Curiosity et al. stay out of scope for the
north star).

These are host-side numpy processes: the noise state lives with the
EnvRunner (one process per runner, vectorized over lanes). Parameter
noise perturbs a module's state_dict leaf by leaf in the JAX package's
pytree order and layout (catalog.flat_order), so one seed perturbs the
same weights by the same draws in both packages.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


class OrnsteinUhlenbeckNoise:
    """dx = theta * (mu - x) * dt + sigma * sqrt(dt) * N(0,1), one state
    row per vector lane (reference ornstein_uhlenbeck_noise.py)."""

    def __init__(self, shape, theta: float = 0.15, sigma: float = 0.2,
                 mu: float = 0.0, dt: float = 1.0, seed: int = 0):
        self.theta = theta
        self.sigma = sigma
        self.mu = mu
        self.dt = dt
        self._shape = tuple(shape)
        self._rng = np.random.default_rng(seed)
        self._x = np.zeros(self._shape, np.float32)

    def reset(self, lanes=None) -> None:
        """Zero the process state (per-lane on episode end: the noise
        correlation must not bridge episodes)."""
        if lanes is None:
            self._x[:] = 0.0
        else:
            self._x[lanes] = 0.0

    def sample(self) -> np.ndarray:
        self._x = (self._x
                   + self.theta * (self.mu - self._x) * self.dt
                   + self.sigma * np.sqrt(self.dt)
                   * self._rng.standard_normal(self._shape)
                   .astype(np.float32))
        return self._x.copy()


class ParameterNoise:
    """Adaptive parameter-space noise (reference parameter_noise.py,
    Plappert et al. 2017): gaussian-perturb every weight leaf with one
    shared stddev; after each sampling round, compare the actions the
    perturbed and clean policies produce and scale sigma to keep their
    distance at `target_action_dist`."""

    def __init__(self, initial_sigma: float = 0.05,
                 target_action_dist: float = 0.1,
                 adapt_coeff: float = 1.01, seed: int = 0):
        self.sigma = float(initial_sigma)
        self.target = float(target_action_dist)
        self.coeff = float(adapt_coeff)
        self._rng = np.random.default_rng(seed)

    def perturb(self, params: Dict[str, Any], module) -> Dict[str, Any]:
        """A state_dict of `module` (numpy or tensors) -> a perturbed
        numpy copy. The draws go leaf by leaf in the JAX params pytree's
        order, each of its leaf's JAX shape (dense kernels [in, out]), as
        the JAX package's jax.tree.map over that tree draws them."""
        from ray_tpu_torch.rllib.core.catalog import flat_order

        order = flat_order(module)
        out = {}
        for key, arr in order.leaves(params):
            if not np.issubdtype(arr.dtype, np.floating):
                out[key] = order.from_jax(arr)
                continue
            out[key] = order.from_jax(arr + self._rng.normal(
                0.0, self.sigma, arr.shape).astype(arr.dtype))
        return out

    def adapt(self, clean_actions: np.ndarray,
              perturbed_actions: np.ndarray) -> float:
        """Update sigma from the measured action divergence; returns the
        new sigma."""
        dist = float(np.sqrt(np.mean(
            (np.asarray(clean_actions, np.float64)
             - np.asarray(perturbed_actions, np.float64)) ** 2)))
        if dist > self.target:
            self.sigma /= self.coeff
        else:
            self.sigma *= self.coeff
        return self.sigma

    def get_state(self) -> Dict[str, float]:
        return {"sigma": self.sigma}

    def set_state(self, state: Dict[str, float]) -> None:
        self.sigma = float(state.get("sigma", self.sigma))
