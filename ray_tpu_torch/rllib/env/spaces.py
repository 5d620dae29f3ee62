"""Minimal gymnasium-compatible spaces.

The image has no gym/gymnasium; these cover what the RL stack needs
(reference envs expose gym.spaces.Box/Discrete — e.g.
rllib/env/single_agent_env_runner.py consumes env.observation_space /
action_space). API-compatible subset: sample(), contains(), shape/dtype/n.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class Space:
    def __init__(self, shape: Tuple[int, ...], dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def sample(self, rng: Optional[np.random.Generator] = None):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape: Optional[Tuple[int, ...]] = None,
                 dtype=np.float32):
        low = np.asarray(low, dtype=dtype)
        high = np.asarray(high, dtype=dtype)
        if shape is not None:
            low = np.broadcast_to(low, shape).astype(dtype)
            high = np.broadcast_to(high, shape).astype(dtype)
        super().__init__(low.shape, dtype)
        self.low, self.high = low, high

    def sample(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        finite = np.isfinite(self.low) & np.isfinite(self.high)
        out = np.where(
            finite,
            rng.uniform(np.where(finite, self.low, 0.0),
                        np.where(finite, self.high, 1.0)),
            rng.standard_normal(self.shape))
        return out.astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and \
            bool(np.all(x >= self.low - 1e-6)) and \
            bool(np.all(x <= self.high + 1e-6))

    def __repr__(self):
        return f"Box({self.shape}, {self.dtype})"


class Discrete(Space):
    def __init__(self, n: int):
        super().__init__((), np.int64)
        self.n = int(n)

    def sample(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        return int(rng.integers(self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"
