"""Atari-style image env wrappers.

reference parity: rllib/env/wrappers/atari_wrappers.py — the standard
DeepMind preprocessing pipeline (NoopResetEnv, MaxAndSkipEnv, WarpFrame
84x84 grayscale, FrameStack, ClipRewardEnv) plus TimeLimit, composable
over this build's Env protocol (so they also apply to gymnasium/ALE envs
through GymnasiumAdapter when the ALE is installed). `wrap_atari` is the
reference's `wrap_deepmind` composition.

TPU-first notes: frames stay uint8 end to end (4x smaller trajectories
through the object store than f32); normalization happens inside the
jitted conv forward (core/catalog.py DiscreteConvModule). Resizing is
pure numpy — integer-factor area mean when exact, bilinear otherwise —
so env workers need no cv2 dependency.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.env.base import Env
from ray_tpu_torch.rllib.env.spaces import Box


class Wrapper(Env):
    """Forward everything to the wrapped env by default."""

    def __init__(self, env: Env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, seed: Optional[int] = None):
        return self.env.reset(seed)

    def step(self, action):
        return self.env.step(action)

    def close(self) -> None:
        self.env.close()

    @property
    def unwrapped(self) -> Env:
        e = self.env
        while isinstance(e, Wrapper):
            e = e.env
        return e


def resize_image(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize [H, W] or [H, W, C] uint8/float arrays.

    Exact integer downscale -> area mean (what cv2 INTER_AREA does for
    integer factors); anything else -> bilinear, all vectorized numpy.
    """
    h, w = img.shape[:2]
    if h == height and w == width:
        return img
    if h % height == 0 and w % width == 0:
        fh, fw = h // height, w // width
        out = img.reshape(height, fh, width, fw, *img.shape[2:])
        return out.mean(axis=(1, 3)).astype(img.dtype)
    # bilinear sample grid
    ys = (np.arange(height) + 0.5) * h / height - 0.5
    xs = (np.arange(width) + 0.5) * w / width - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    f = img.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(img.dtype)


def rgb_to_gray(obs: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma [..., 3] -> [...] uint8, integer math (shared by
    WarpFrame and the connector pipeline so both stay bit-identical)."""
    return ((77 * obs[..., 0].astype(np.uint16)
             + 150 * obs[..., 1].astype(np.uint16)
             + 29 * obs[..., 2].astype(np.uint16)) >> 8).astype(np.uint8)


class WarpFrame(Wrapper):
    """Grayscale + resize to [dim, dim, 1] uint8 (reference WarpFrame:
    84x84 grayscale, the Nature-DQN observation)."""

    def __init__(self, env: Env, dim: int = 84):
        super().__init__(env)
        self.dim = dim
        self.observation_space = Box(0, 255, (dim, dim, 1), np.uint8)

    def _warp(self, obs: np.ndarray) -> np.ndarray:
        if obs.ndim == 3 and obs.shape[-1] == 3:
            obs = rgb_to_gray(obs)
        elif obs.ndim == 3 and obs.shape[-1] == 1:
            obs = obs[..., 0]
        out = resize_image(obs, self.dim, self.dim)
        return out[..., None]

    def reset(self, seed: Optional[int] = None):
        obs, info = self.env.reset(seed)
        return self._warp(np.asarray(obs)), info

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        return self._warp(np.asarray(obs)), r, term, trunc, info


class FrameStack(Wrapper):
    """Stack the last k frames along the channel axis (reference
    FrameStack; [H, W, 1] x k -> [H, W, k])."""

    def __init__(self, env: Env, k: int = 4):
        super().__init__(env)
        self.k = k
        h, w, c = env.observation_space.shape
        self._frames = np.zeros((h, w, c * k),
                                env.observation_space.dtype)
        self.observation_space = Box(0, 255, (h, w, c * k),
                                     env.observation_space.dtype)
        self._c = c

    def _push(self, obs: np.ndarray) -> np.ndarray:
        self._frames = np.roll(self._frames, shift=-self._c, axis=-1)
        self._frames[..., -self._c:] = obs
        return self._frames.copy()

    def reset(self, seed: Optional[int] = None):
        obs, info = self.env.reset(seed)
        self._frames[:] = 0
        return self._push(np.asarray(obs)), info

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        return self._push(np.asarray(obs)), r, term, trunc, info


class MaxAndSkipEnv(Wrapper):
    """Repeat the action `skip` times, return the elementwise max of the
    last two raw frames (reference MaxAndSkipEnv — defeats Atari sprite
    flicker and cuts inference cost 4x)."""

    def __init__(self, env: Env, skip: int = 4):
        super().__init__(env)
        self.skip = max(1, skip)

    def step(self, action):
        total = 0.0
        term = trunc = False
        info: Dict[str, Any] = {}
        prev = obs = None
        for _ in range(self.skip):
            prev = obs
            obs, r, term, trunc, info = self.env.step(action)
            total += r
            if term or trunc:
                break
        if prev is not None:
            obs = np.maximum(np.asarray(obs), np.asarray(prev))
        return obs, total, term, trunc, info


class ClipRewardEnv(Wrapper):
    """Clip rewards to {-1, 0, +1} by sign (reference ClipRewardEnv)."""

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        return obs, float(np.sign(r)), term, trunc, info


class NoopResetEnv(Wrapper):
    """Take a random number of no-op actions on reset (reference
    NoopResetEnv — decorrelates initial states)."""

    def __init__(self, env: Env, noop_max: int = 30, noop_action: int = 0):
        super().__init__(env)
        self.noop_max = noop_max
        self.noop_action = noop_action
        self._rng = np.random.default_rng()

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        obs, info = self.env.reset(seed)
        for _ in range(int(self._rng.integers(0, self.noop_max + 1))):
            obs, _, term, trunc, info = self.env.step(self.noop_action)
            if term or trunc:
                obs, info = self.env.reset()
        return obs, info


class TimeLimit(Wrapper):
    """Truncate episodes at max_episode_steps (gym TimeLimit)."""

    def __init__(self, env: Env, max_episode_steps: int):
        super().__init__(env)
        self.max_episode_steps = max_episode_steps
        self._t = 0

    def reset(self, seed: Optional[int] = None):
        self._t = 0
        return self.env.reset(seed)

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        self._t += 1
        if self._t >= self.max_episode_steps and not term:
            trunc = True
        return obs, r, term, trunc, info


def wrap_atari(env: Env, *, dim: int = 84, framestack: int = 4,
               frameskip: int = 4, clip_rewards: bool = True,
               noop_max: int = 0,
               max_episode_steps: Optional[int] = None) -> Env:
    """The reference's wrap_deepmind composition over this Env protocol:
    [NoopReset] -> MaxAndSkip -> WarpFrame -> [ClipReward] -> FrameStack
    [-> TimeLimit]. Output contract: [dim, dim, framestack] uint8."""
    if noop_max:
        env = NoopResetEnv(env, noop_max=noop_max)
    if frameskip > 1:
        env = MaxAndSkipEnv(env, skip=frameskip)
    env = WarpFrame(env, dim=dim)
    if clip_rewards:
        env = ClipRewardEnv(env)
    env = FrameStack(env, k=framestack)
    if max_episode_steps:
        env = TimeLimit(env, max_episode_steps)
    return env
