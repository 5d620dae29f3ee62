"""MiniPong: a procedurally generated Pong-class pixel environment.

Stands in for ALE Pong in the north-star Atari configs (BASELINE.md #2
/#3: PPO/IMPALA Pong with CPU EnvRunner fleets feeding a TPU learner;
reference tuned_examples/impala/pong-impala-fast.yaml:1-5) on images,
since the ALE is not installable in this environment. Raw frames are
168x168x3 RGB uint8 — the standard `wrap_atari` pipeline (MaxAndSkip ->
WarpFrame 84x84 grayscale -> FrameStack 4) produces exactly the Atari
tensor contract, exercising the full preprocessing path.

Game (single-player pong-squash): a ball launches from the top with a
random diagonal velocity and bounces off the top and side walls; the
agent moves a paddle along the bottom (LEFT/STAY/RIGHT). Returning the
ball scores +1 and re-launches it at a random angle; missing scores -1
and ends the episode; `max_returns` returns win the episode. Unlike
CatchPixels (straight drop, 7 steps), interception here requires
tracking diagonal motion through wall bounces over a ~20x longer
horizon — credit assignment and perception are Pong-shaped.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.env.base import Env, register_env
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
from ray_tpu_torch.rllib.env.wrappers import wrap_atari

SIZE = 21          # logical court cells per side
CELL = 8           # render pixels per cell -> 168x168
PADDLE_W = 3       # paddle width in cells (config "paddle_w" overrides)


class MiniPongRaw(Env):
    """Raw 168x168x3 uint8 frames, unwrapped.

    Config knobs scale difficulty for CI-budget learning smokes:
    paddle_w (wider paddle = denser reward), max_returns (episode
    length), speeds (horizontal velocity choices)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.max_returns = int(config.get("max_returns", 5))
        self.paddle_w = int(config.get("paddle_w", PADDLE_W))
        self.speeds = tuple(config.get(
            "speeds", (-1.0, -0.5, 0.5, 1.0)))
        self.observation_space = Box(
            0, 255, (SIZE * CELL, SIZE * CELL, 3), np.uint8)
        self.action_space = Discrete(3)
        self._rng = np.random.default_rng(config.get("seed"))
        self._returns = 0
        self._bx = self._by = 0.0
        self._vx = self._vy = 0.0
        self._paddle = SIZE // 2

    def _launch(self) -> None:
        self._bx = float(self._rng.integers(3, SIZE - 3))
        self._by = 1.0
        self._vx = float(self._rng.choice(self.speeds))
        self._vy = 1.0

    def _render(self) -> np.ndarray:
        frame = np.zeros((SIZE * CELL, SIZE * CELL, 3), np.uint8)
        bx = int(np.clip(round(self._bx), 0, SIZE - 1))
        by = int(np.clip(round(self._by), 0, SIZE - 1))
        frame[by * CELL:(by + 1) * CELL,
              bx * CELL:(bx + 1) * CELL] = (236, 236, 236)
        pw = self.paddle_w
        lo = self._paddle - pw // 2
        lo = int(np.clip(lo, 0, SIZE - pw))
        frame[(SIZE - 1) * CELL:,
              lo * CELL:(lo + pw) * CELL] = (92, 186, 92)
        return frame

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._returns = 0
        self._paddle = SIZE // 2
        self._launch()
        return self._render(), {}

    def step(self, action: int):
        self._paddle = int(np.clip(self._paddle + (int(action) - 1),
                                   self.paddle_w // 2,
                                   SIZE - 1 - self.paddle_w // 2))
        self._bx += self._vx
        self._by += self._vy
        # side/top wall bounces
        if self._bx < 0:
            self._bx = -self._bx
            self._vx = -self._vx
        elif self._bx > SIZE - 1:
            self._bx = 2 * (SIZE - 1) - self._bx
            self._vx = -self._vx
        if self._by < 0:
            self._by = -self._by
            self._vy = 1.0
        reward = 0.0
        terminated = False
        if self._by >= SIZE - 1:  # reached the paddle row
            if abs(round(self._bx) - self._paddle) <= self.paddle_w // 2:
                reward = 1.0
                self._returns += 1
                if self._returns >= self.max_returns:
                    terminated = True
                else:
                    # bounce up with a fresh random horizontal direction
                    self._by = float(SIZE - 2)
                    self._vy = -1.0
                    self._vx = float(self._rng.choice(self.speeds))
            else:
                reward = -1.0
                terminated = True
        elif self._vy < 0 and self._by <= 1.0:
            # returning ball reaches the top: fall again
            self._vy = 1.0
        return self._render(), reward, terminated, False, {}


def make_minipong(config: Optional[Dict[str, Any]] = None) -> Env:
    """MiniPong with the DeepMind pipeline: [84, 84, 4] uint8 obs,
    4x frameskip, clipped rewards, 400-step (1600 raw frames) limit."""
    config = dict(config or {})
    frameskip = int(config.pop("frameskip", 2))
    return wrap_atari(
        MiniPongRaw(config), dim=84, framestack=4, frameskip=frameskip,
        clip_rewards=True, max_episode_steps=400)


register_env("MiniPong-v0", make_minipong)
# raw frames, no preprocessing: the connector-pipeline entry point
# (rllib/connectors deepmind_connectors supplies the DeepMind transforms)
register_env("MiniPongRaw-v0",
             lambda config=None: MiniPongRaw(config))
