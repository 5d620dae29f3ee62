"""CartPole-v1: numpy implementation of the classic control task.

Standard cart-pole dynamics (Barto, Sutton & Anderson 1983) with the
gymnasium CartPole-v1 constants: +1 reward per step, termination at
|x| > 2.4 or |theta| > 12deg, truncation at 500 steps. Built in because
the image ships no gym; used by the PPO/IMPALA learning tests
(BASELINE.json config 1; reference CI threshold
rllib/tuned_examples/impala/cartpole-impala.yaml:5-6).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.env.base import Env, register_env
from ray_tpu_torch.rllib.env.spaces import Box, Discrete


class CartPoleEnv(Env):
    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5          # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        high = np.array([self.X_LIMIT * 2, np.inf,
                         self.THETA_LIMIT * 2, np.inf], np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng()
        self._state = np.zeros(4, np.float32)
        self._steps = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        self._steps = 0
        return self._state.copy(), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if int(action) == 1 else -self.FORCE_MAG
        costheta, sintheta = math.cos(theta), math.sin(theta)
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH

        temp = (force + polemass_length * theta_dot ** 2 * sintheta) \
            / total_mass
        theta_acc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0
                           - self.MASSPOLE * costheta ** 2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * costheta / total_mass

        x += self.TAU * x_dot
        x_dot += self.TAU * x_acc
        theta += self.TAU * theta_dot
        theta_dot += self.TAU * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self._steps += 1

        terminated = bool(abs(x) > self.X_LIMIT
                          or abs(theta) > self.THETA_LIMIT)
        truncated = self._steps >= self.MAX_STEPS
        return self._state.copy(), 1.0, terminated, truncated, {}


register_env("CartPole-v1", CartPoleEnv)
