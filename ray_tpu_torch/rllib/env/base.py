"""Env API (gymnasium-style 5-tuple protocol) + registry.

reference parity: RLlib consumes gym.Env everywhere
(env/single_agent_env_runner.py:34 builds gym.vector envs; env registry
via tune.register_env). Same protocol here:
reset(seed) -> (obs, info); step(a) -> (obs, reward, terminated,
truncated, info). Register custom envs with register_env(name, creator);
gymnasium envs plug in unchanged if the package is present.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

_ENV_REGISTRY: Dict[str, Callable[[Dict[str, Any]], "Env"]] = {}


class Env:
    observation_space = None
    action_space = None

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def close(self) -> None:
        pass


def register_env(name: str,
                 creator: Callable[[Dict[str, Any]], Env]) -> None:
    """reference: ray.tune.register_env."""
    _ENV_REGISTRY[name] = creator


class GymnasiumAdapter(Env):
    """Wrap a gymnasium.Env into this protocol: keyword-only reset(seed=)
    becomes positional, and gymnasium spaces are converted to the local
    Box/Discrete so catalog isinstance dispatch works (reference RLlib
    consumes gym envs natively; this build's spaces are a subset)."""

    def __init__(self, gym_env):
        self._env = gym_env
        self.observation_space = self._convert(gym_env.observation_space)
        self.action_space = self._convert(gym_env.action_space)

    @staticmethod
    def _convert(space):
        import gymnasium
        from ray_tpu_torch.rllib.env.spaces import Box, Discrete
        if isinstance(space, gymnasium.spaces.Discrete):
            return Discrete(int(space.n))
        if isinstance(space, gymnasium.spaces.Box):
            return Box(space.low, space.high, dtype=space.dtype)
        raise NotImplementedError(
            f"unsupported gymnasium space {type(space).__name__}")

    def reset(self, seed: Optional[int] = None):
        return self._env.reset(seed=seed)

    def step(self, action):
        import numpy as np
        a = np.asarray(action, self.action_space.dtype) \
            if self.action_space.shape else action
        return self._env.step(a)

    def close(self) -> None:
        self._env.close()


def make_env(name: str, config: Optional[Dict[str, Any]] = None) -> Env:
    config = config or {}
    if name in _ENV_REGISTRY:
        return _ENV_REGISTRY[name](config)
    # fall through to gymnasium when available
    try:
        import gymnasium
        return GymnasiumAdapter(gymnasium.make(name))
    except ImportError:
        pass
    raise KeyError(
        f"unknown env {name!r}; register it with "
        "ray_tpu_torch.rllib.register_env(name, creator)")
