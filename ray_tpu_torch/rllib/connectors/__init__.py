"""Connector pipelines: composable obs/reward/action transforms.

reference parity: rllib/connectors/connector.py:1 (Connector /
ConnectorPipeline), connectors/agent/obs_preproc.py (obs preprocessing),
agent/mean_std_filter.py, agent/clip_reward.py, action connectors —
preprocessing decoupled from env wrappers so the same env can feed
different algorithms with different pipelines, and pipeline state
(frame stacks, running filters) checkpoints with the runner.

TPU-first shape: connectors transform the VECTORIZED lane batch at the
EnvRunner boundary — obs [N, ...] / rewards [N] across all vector lanes
in one numpy op — instead of the reference's per-agent python dicts, so
per-step python cost is O(1) in lane count.

The step contract carries the per-lane true FINAL observations of
episodes that ended this step (None for live lanes): bootstrap values
are computed from them, so they must pass through the same obs
transforms as the stream itself.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.env.spaces import Box


class EnvConnector:
    """Observation/reward-side connector (reference agent connectors)."""

    def observation_space(self, space):
        return space

    def on_reset(self, obs: np.ndarray) -> np.ndarray:
        return obs

    def on_step(self, obs: np.ndarray, rewards: np.ndarray,
                terms: np.ndarray, truncs: np.ndarray,
                finals: List[Optional[np.ndarray]]):
        """-> (obs, rewards, finals), each transformed."""
        return obs, rewards, finals

    # pipeline state rides runner checkpoints (reference Connector
    # serialization)
    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ActionConnector:
    """Action-side connector (reference action connectors): transforms
    the batched actions [N, ...] on their way to the env."""

    def __call__(self, actions: np.ndarray) -> np.ndarray:
        return actions


class ConnectorPipeline:
    """Ordered composition (reference ConnectorPipeline)."""

    def __init__(self, connectors: Optional[List[EnvConnector]] = None):
        self.connectors = list(connectors or [])

    def observation_space(self, space):
        for c in self.connectors:
            space = c.observation_space(space)
        return space

    def on_reset(self, obs):
        for c in self.connectors:
            obs = c.on_reset(obs)
        return obs

    def on_step(self, obs, rewards, terms, truncs, finals):
        for c in self.connectors:
            obs, rewards, finals = c.on_step(obs, rewards, terms,
                                             truncs, finals)
        return obs, rewards, finals

    def get_state(self) -> List[Dict[str, Any]]:
        return [c.get_state() for c in self.connectors]

    def set_state(self, states: List[Dict[str, Any]]) -> None:
        for c, s in zip(self.connectors, states):
            c.set_state(s)


class GrayscaleResizeConnector(EnvConnector):
    """RGB [N, H, W, 3] -> resized grayscale [N, dim, dim, 1] uint8
    (reference agent/obs_preproc.py / WarpFrame as a connector)."""

    def __init__(self, dim: int = 84):
        self.dim = dim

    def observation_space(self, space):
        return Box(0, 255, (self.dim, self.dim, 1), np.uint8)

    def _warp_one(self, obs: np.ndarray) -> np.ndarray:
        from ray_tpu_torch.rllib.env.wrappers import resize_image, rgb_to_gray
        if obs.shape[-1] == 3:
            gray = rgb_to_gray(obs)  # same luma as WarpFrame:
        else:                        # pipelines stay bit-identical
            gray = obs[..., 0]
        return resize_image(gray, self.dim, self.dim
                            ).astype(np.uint8)[..., None]

    def _warp(self, obs: np.ndarray) -> np.ndarray:
        return np.stack([self._warp_one(o) for o in obs])

    def on_reset(self, obs):
        return self._warp(obs)

    def on_step(self, obs, rewards, terms, truncs, finals):
        finals = [None if f is None else self._warp_one(np.asarray(f))
                  for f in finals]
        return self._warp(obs), rewards, finals


class FrameStackConnector(EnvConnector):
    """Stack the last k frames per lane along the channel axis
    (reference FrameStack as a stateful agent connector). Reset/episode
    boundaries zero the lane's history + push the first frame — the
    exact env/wrappers.FrameStack semantics, bit-identical pipelines."""

    def __init__(self, k: int = 4):
        self.k = k
        self._stack: Optional[np.ndarray] = None  # [N, H, W, C*k]

    def observation_space(self, space):
        h, w, c = space.shape
        return Box(0, 255, (h, w, c * self.k), space.dtype)

    def on_reset(self, obs):
        n, h, w, c = obs.shape
        self._stack = np.zeros((n, h, w, c * self.k), obs.dtype)
        self._stack[..., -c:] = obs
        return self._stack.copy()

    def on_step(self, obs, rewards, terms, truncs, finals):
        c = obs.shape[-1]
        # finals first: an episode's true final stack is the PRE-update
        # lane history rolled with the final frame
        out_finals: List[Optional[np.ndarray]] = []
        for lane, f in enumerate(finals):
            if f is None:
                out_finals.append(None)
            else:
                out_finals.append(np.concatenate(
                    [self._stack[lane][..., c:], np.asarray(f)],
                    axis=-1))
        self._stack = np.concatenate(
            [self._stack[..., c:], obs], axis=-1)
        done = np.asarray(terms) | np.asarray(truncs)
        if done.any():
            # episode boundary: the incoming obs is the autoreset frame;
            # zero the lane's history like a wrapper-stack reset would
            lanes = np.nonzero(done)[0]
            self._stack[lanes] = 0
            self._stack[lanes, ..., -c:] = obs[lanes]
        return self._stack.copy(), rewards, out_finals

    def get_state(self):
        return {"stack": None if self._stack is None
                else self._stack.copy()}

    def set_state(self, state):
        self._stack = state.get("stack")


class ClipRewardConnector(EnvConnector):
    """sign() or [-bound, bound] clip (reference agent/clip_reward.py)."""

    def __init__(self, sign: bool = True, bound: float = 1.0):
        self.sign = sign
        self.bound = bound

    def on_step(self, obs, rewards, terms, truncs, finals):
        if self.sign:
            return obs, np.sign(rewards).astype(np.float32), finals
        return obs, np.clip(rewards, -self.bound,
                            self.bound).astype(np.float32), finals


class MeanStdFilterConnector(EnvConnector):
    """Running mean/std observation normalization (reference
    agent/mean_std_filter.py — Welford accumulation; the filter state
    checkpoints with the runner). Final observations are normalized with
    the current filter but do not update it."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def _update(self, obs: np.ndarray) -> None:
        # batched (Chan et al.) Welford merge: one vectorized update per
        # step regardless of lane count — O(1) python in N
        batch = np.asarray(obs, np.float64)
        n = batch.shape[0]
        if n == 0:
            return
        bmean = batch.mean(axis=0)
        bm2 = ((batch - bmean) ** 2).sum(axis=0)
        if self._mean is None:
            self._mean = bmean
            self._m2 = bm2
            self._count = float(n)
            return
        delta = bmean - self._mean
        total = self._count + n
        self._mean = self._mean + delta * (n / total)
        self._m2 = self._m2 + bm2 + delta ** 2 * (self._count * n / total)
        self._count = total

    def _apply(self, obs: np.ndarray) -> np.ndarray:
        if self._mean is None or self._count < 2:
            return np.asarray(obs, np.float32)
        std = np.sqrt(self._m2 / (self._count - 1)) + self.eps
        out = (np.asarray(obs, np.float64) - self._mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def observation_space(self, space):
        return Box(-self.clip, self.clip, space.shape, np.float32)

    def on_reset(self, obs):
        self._update(obs)
        return self._apply(obs)

    def on_step(self, obs, rewards, terms, truncs, finals):
        self._update(obs)
        finals = [None if f is None else self._apply(f) for f in finals]
        return self._apply(obs), rewards, finals

    def get_state(self):
        # copies: checkpoint state must not alias the live Welford
        # accumulators (updated in place every step)
        return {"count": self._count,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state):
        self._count = state.get("count", 0.0)
        mean = state.get("mean")
        m2 = state.get("m2")
        self._mean = None if mean is None else np.array(mean)
        self._m2 = None if m2 is None else np.array(m2)


class ClipActionConnector(ActionConnector):
    """Clip continuous actions into the env's bounds (reference action
    connectors' clip)."""

    def __init__(self, low, high):
        self.low = np.asarray(low)
        self.high = np.asarray(high)

    def __call__(self, actions):
        return np.clip(actions, self.low, self.high)


def deepmind_connectors(dim: int = 84, framestack: int = 4,
                        clip_rewards: bool = True
                        ) -> List[EnvConnector]:
    """The DeepMind Atari preprocessing as a connector pipeline
    (reference wrap_deepmind ported onto connectors; frame-skip stays an
    env wrapper because it changes stepping, not observations)."""
    out: List[EnvConnector] = [GrayscaleResizeConnector(dim=dim),
                               FrameStackConnector(k=framestack)]
    if clip_rewards:
        out.append(ClipRewardConnector(sign=True))
    return out
