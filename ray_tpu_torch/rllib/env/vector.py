"""Synchronous vector env with autoreset.

reference parity: RLlib's EnvRunner steps gym.vector.VectorEnv
(env/single_agent_env_runner.py:34,139 — vectorized envs with autoreset
semantics: when a sub-env terminates/truncates, the returned obs is the
reset obs of the next episode).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.env.base import Env


class SyncVectorEnv:
    def __init__(self, env_fns: List[Callable[[], Env]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def reset(self, seed: Optional[int] = None):
        obs, infos = [], []
        for i, e in enumerate(self.envs):
            o, info = e.reset(None if seed is None else seed + i)
            obs.append(o)
            infos.append(info)
        return np.stack(obs), infos

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, List[Dict[str, Any]],
                                     np.ndarray]:
        """Returns (obs, rewards, terminated, truncated, infos,
        final_obs): when env i finishes, obs[i] is already the next
        episode's reset obs and final_obs[i] holds the true terminal
        observation (needed for correct value bootstrapping on
        truncation)."""
        # coerce once up front: a device-resident actions array handed
        # in here would otherwise pay one device->host sync per lane per
        # step inside the loop (each env coerces its scalar lane)
        actions = np.asarray(actions)
        obs, rewards, terms, truncs, infos = [], [], [], [], []
        final_obs = [None] * self.num_envs
        for i, (e, a) in enumerate(zip(self.envs, actions)):
            o, r, term, trunc, info = e.step(a)
            if term or trunc:
                final_obs[i] = o
                o, _ = e.reset()
            obs.append(o)
            rewards.append(r)
            terms.append(term)
            truncs.append(trunc)
            infos.append(info)
        return (np.stack(obs), np.asarray(rewards, np.float32),
                np.asarray(terms), np.asarray(truncs), infos, final_obs)

    def close(self) -> None:
        for e in self.envs:
            e.close()
