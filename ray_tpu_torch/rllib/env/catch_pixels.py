"""CatchPixels: a deterministic image env with the Atari tensor contract.

reference parity: stands in for the ALE/atari_wrappers path
(rllib/env/wrappers/atari_wrappers.py — 84x84 grayscale, 4-frame stack,
uint8) on images without the ALE: same [84, 84, 4] uint8 observation
contract and Discrete actions, so conv catalogs, preprocessing and
throughput behave like the Pong north-star configs (BASELINE.md 2-3).

Game: a ball drops from the top in one of 7 columns; a 1-column paddle
at the bottom moves LEFT/STAY/RIGHT. Catch → +1, miss → -1. One drop per
episode (7 steps). Solvable to reward=1.0; random play ≈ -0.5.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.env.base import Env, register_env
from ray_tpu_torch.rllib.env.spaces import Box, Discrete

GRID = 7            # logical columns/rows
CELL = 12           # pixel block per logical cell → 84x84
FRAMES = 4


class CatchPixels(Env):
    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.observation_space = Box(0, 255, (84, 84, FRAMES), np.uint8)
        self.action_space = Discrete(3)
        self._rng = np.random.default_rng(config.get("seed"))
        self._frames = np.zeros((84, 84, FRAMES), np.uint8)
        self._ball_col = 0
        self._ball_row = 0
        self._paddle = GRID // 2

    def _render(self) -> np.ndarray:
        frame = np.zeros((84, 84), np.uint8)
        r, c = self._ball_row, self._ball_col
        if r < GRID:
            frame[r * CELL:(r + 1) * CELL, c * CELL:(c + 1) * CELL] = 255
        p = self._paddle
        frame[(GRID - 1) * CELL:, p * CELL:(p + 1) * CELL] = \
            np.maximum(frame[(GRID - 1) * CELL:, p * CELL:(p + 1) * CELL],
                       128)
        return frame

    def _obs(self) -> np.ndarray:
        self._frames = np.roll(self._frames, shift=-1, axis=-1)
        self._frames[..., -1] = self._render()
        return self._frames.copy()

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ball_col = int(self._rng.integers(GRID))
        self._ball_row = 0
        self._paddle = GRID // 2
        self._frames[:] = 0
        return self._obs(), {}

    def step(self, action: int):
        self._paddle = int(np.clip(self._paddle + (int(action) - 1),
                                   0, GRID - 1))
        self._ball_row += 1
        terminated = self._ball_row >= GRID - 1
        reward = 0.0
        if terminated:
            reward = 1.0 if self._paddle == self._ball_col else -1.0
        return self._obs(), reward, terminated, False, {}


register_env("CatchPixels-v0", CatchPixels)
