"""Multi-agent environments with shared-policy training.

reference parity: rllib/env/multi_agent_env.py — MultiAgentEnv speaks
dicts keyed by agent id: reset() -> ({agent: obs}, infos);
step({agent: action}) -> (obs, rewards, terminateds, truncateds, infos)
with the special "__all__" key ending the episode; make_multi_agent
(:449) turns any registered single-agent env into an N-agent copy for
testing. Scope here: a fixed agent roster with homogeneous spaces and a
SHARED policy — each agent becomes one lane of the standard [T, N]
fragment layout, so PPO/IMPALA/GAE run unchanged (the reference's
per-policy mapping is future work; shared policy is its default too).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ray_tpu_torch.rllib.env.base import Env, make_env


class MultiAgentEnv:
    """Dict-keyed env protocol (reference MultiAgentEnv)."""

    # fixed roster; subclasses set in __init__
    agents: List[str] = []
    observation_space = None   # shared (homogeneous) per-agent space
    action_space = None

    def reset(self, seed: Optional[int] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        """-> (obs, rewards, terminateds, truncateds, infos); the
        terminateds/truncateds dicts carry per-agent flags plus
        "__all__" for episode end."""
        raise NotImplementedError

    def close(self) -> None:
        pass


def make_multi_agent(env_name_or_creator: Union[str, Callable],
                     ) -> Callable[[Dict[str, Any]], "MultiAgentEnv"]:
    """reference make_multi_agent: N independent copies of a
    single-agent env exposed as agents "agent_0..agent_{n-1}"; config
    key num_agents picks N."""

    class _CopyMultiAgent(MultiAgentEnv):
        def __init__(self, config: Optional[Dict[str, Any]] = None):
            config = dict(config or {})
            n = int(config.pop("num_agents", 2))
            if callable(env_name_or_creator):
                self._envs = [env_name_or_creator(config)
                              for _ in range(n)]
            else:
                self._envs = [make_env(env_name_or_creator, config)
                              for _ in range(n)]
            self.agents = [f"agent_{i}" for i in range(n)]
            self.observation_space = self._envs[0].observation_space
            self.action_space = self._envs[0].action_space
            self._reset_count = 0

        def reset(self, seed: Optional[int] = None):
            obs, infos = {}, {}
            for i, (a, e) in enumerate(zip(self.agents, self._envs)):
                o, info = e.reset(None if seed is None else seed + i)
                obs[a], infos[a] = o, info
            return obs, infos

        def step(self, actions: Dict[str, Any]):
            # independent sub-envs auto-reset per agent (no shared
            # state), so lanes never idle waiting for "__all__" — the
            # reference's copy env behaves the same way
            obs, rews, terms, truncs, infos = {}, {}, {}, {}, {}
            for i, (a, e) in enumerate(zip(self.agents, self._envs)):
                o, r, te, tr, info = e.step(actions[a])
                rews[a] = r
                terms[a], truncs[a] = te, tr
                if te or tr:
                    self._reset_count += 1
                    new_o, _ = e.reset(self._reset_count * 7919 + i)
                    obs[a] = new_o
                    infos[a] = {"final_obs": o}
                else:
                    obs[a], infos[a] = o, info
            terms["__all__"] = False
            truncs["__all__"] = False
            return obs, rews, terms, truncs, infos

        def close(self):
            for e in self._envs:
                e.close()

    return _CopyMultiAgent


class MultiAgentVectorAdapter:
    """Adapt fixed-roster MultiAgentEnvs to the SyncVectorEnv surface:
    each (env, agent) pair is one lane of the [T, N] fragment layout.

    Episode ends via "__all__" reset every lane together; lanes that
    had no per-agent flag get the boundary flag synthesized so GAE and
    episode metrics see the episode end. Agents that end BEFORE
    "__all__" idle their lane (frozen obs, zero reward, no further done
    flags) until the joint reset; those filler rows DO enter training
    with small (gamma-1)*V advantages — a known bias of the lane
    layout. Prefer envs whose agents end together or auto-reset per
    agent (make_multi_agent does) — the reference avoids this by
    collecting per-agent episode objects instead of lanes.
    """

    def __init__(self, env_fns: List[Callable[[], MultiAgentEnv]]):
        self.envs = [fn() for fn in env_fns]
        for e in self.envs:
            if not isinstance(e, MultiAgentEnv):
                raise TypeError(f"expected MultiAgentEnv, got {type(e)}")
        self.agents_per_env = [list(e.agents) for e in self.envs]
        self.num_envs = sum(len(a) for a in self.agents_per_env)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._last_obs: List[Any] = [None] * self.num_envs
        self._ended: List[bool] = [False] * self.num_envs
        self._seed_counter = 0

    def _lanes(self):
        lane = 0
        for ei, agents in enumerate(self.agents_per_env):
            for a in agents:
                yield lane, ei, a
                lane += 1

    def reset(self, seed: Optional[int] = None):
        infos: List[Dict[str, Any]] = []
        for ei, e in enumerate(self.envs):
            obs, info = e.reset(None if seed is None else seed + ei)
            infos.extend(info.get(a, {}) for a in self.agents_per_env[ei])
            base = sum(len(x) for x in self.agents_per_env[:ei])
            for j, a in enumerate(self.agents_per_env[ei]):
                self._last_obs[base + j] = obs[a]
                self._ended[base + j] = False
        return np.stack(self._last_obs), infos

    def step(self, actions):
        rewards = np.zeros(self.num_envs, np.float32)
        terms = np.zeros(self.num_envs, bool)
        truncs = np.zeros(self.num_envs, bool)
        infos: List[Dict[str, Any]] = [{} for _ in range(self.num_envs)]
        final_obs: List[Any] = [None] * self.num_envs

        for ei, e in enumerate(self.envs):
            agents = self.agents_per_env[ei]
            base = sum(len(x) for x in self.agents_per_env[:ei])
            act = {a: actions[base + j]
                   for j, a in enumerate(agents)
                   if not self._ended[base + j]}
            obs, rews, te, tr, info = e.step(act)
            all_done = te.get("__all__", False) or \
                tr.get("__all__", False)
            env_term = te.get("__all__", False)
            for j, a in enumerate(agents):
                lane = base + j
                lane_info = info.get(a, {})
                rewards[lane] = float(rews.get(a, 0.0))
                if not self._ended[lane]:
                    terms[lane] = bool(te.get(a, False))
                    truncs[lane] = bool(tr.get(a, False))
                    if all_done and not (terms[lane] or truncs[lane]):
                        # episode ended via "__all__" only: the lane
                        # still needs its boundary flag, else GAE would
                        # bridge into the next episode and episode
                        # metrics would never complete
                        terms[lane] = env_term
                        truncs[lane] = not env_term
                    if terms[lane] or truncs[lane]:
                        # true final obs, most-authoritative first:
                        # explicit info["final_obs"] (autoresetting
                        # envs), the done-step obs[a] (plain envs), or
                        # the pre-step obs as a last resort (envs that
                        # drop done agents without reporting — the
                        # bootstrap is then one step stale)
                        if "final_obs" in lane_info:
                            final_obs[lane] = lane_info["final_obs"]
                        elif a in obs:
                            final_obs[lane] = obs[a]
                        else:
                            final_obs[lane] = self._last_obs[lane]
                        if a not in obs:
                            # no replacement obs: this agent idles
                            # until the episode's "__all__"
                            self._ended[lane] = True
                if a in obs:
                    self._last_obs[lane] = obs[a]
                infos[lane] = lane_info
            if all_done:
                self._seed_counter += 1
                new_obs, _ = e.reset(self._seed_counter * 977 + ei)
                for j, a in enumerate(agents):
                    lane = base + j
                    self._last_obs[lane] = new_obs[a]
                    self._ended[lane] = False
        return (np.stack(self._last_obs), rewards, terms, truncs,
                infos, final_obs)

    def close(self) -> None:
        for e in self.envs:
            e.close()
