"""EnvRunner: CPU rollout workers shipping trajectories.

The port's counterpart of ray_tpu/rllib/env/env_runner.py (reference
parity: rllib/env/env_runner.py:15 (EnvRunner ABC) +
single_agent_env_runner.py:34,99,139,312 — vector envs stepped with
module.forward_exploration (:227), episodes returned to the driver
through the object store). Runners are plain classes here; the Algorithm
wraps them in actors (`ray_tpu_torch.remote`) for num_env_runners > 0
exactly like WorkerSet does (evaluation/worker_set.py:82).

A runner always acts on the CPU: its module is its own CPU copy, run
under torch.no_grad(), and weights arrive as CPU numpy via set_weights
(broadcast from the Learner over the object store), so nothing in a
runner touches CUDA. A runner in an actor (worker_index > 0) runs torch
on one thread: the actors of one node share its cores.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import RLModule
from ray_tpu_torch.rllib.env.base import make_env
from ray_tpu_torch.rllib.env.vector import SyncVectorEnv


class SingleAgentEnvRunner:
    def __init__(self, env_name: str, module: RLModule,
                 env_config: Optional[Dict[str, Any]] = None,
                 num_envs: int = 1, seed: Optional[int] = None,
                 worker_index: int = 0, gamma: float = 0.99):
        if worker_index > 0:
            torch.set_num_threads(1)
        from ray_tpu_torch.rllib.env.multi_agent import (
            MultiAgentEnv, MultiAgentVectorAdapter)
        # the probe (type dispatch) becomes the first vector member so
        # its construction isn't wasted
        probe = make_env(env_name, env_config)
        env_fns = [lambda: probe] + [
            functools.partial(make_env, env_name, env_config)
            for _ in range(num_envs - 1)]
        if isinstance(probe, MultiAgentEnv):
            # shared policy: each (env, agent) pair is one vector lane
            self.env = MultiAgentVectorAdapter(env_fns)
        else:
            self.env = SyncVectorEnv(env_fns)
        # the runner's own CPU copy (a driver-local runner must not share
        # the algorithm's module object with anything that moves it)
        self.module = copy.deepcopy(module).to("cpu").eval()
        self.worker_index = worker_index
        self.gamma = gamma
        self._gen = torch.Generator().manual_seed(
            (seed if seed is not None else 0) * 10007 + worker_index)
        self._has_weights = False

        base_seed = None if seed is None else seed + worker_index * 1000
        self._obs, _ = self.env.reset(base_seed)
        # per-env running episode returns/lengths for metrics
        self._ep_ret = np.zeros(self.env.num_envs, np.float64)
        self._ep_len = np.zeros(self.env.num_envs, np.int64)
        self._completed: List[Dict[str, float]] = []

    @torch.no_grad()
    def _forward_explore(self, obs) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        """Batched stochastic forward -> (actions, logp, vf_preds) as
        numpy rows aligned with the vector lanes; actions are int32, as
        the JAX package's runner samples them."""
        out = self.module.forward_exploration(
            {"obs": torch.from_numpy(np.asarray(obs))}, self._gen)
        return (out["actions"].numpy().astype(np.int32),
                out["action_logp"].numpy(), out["vf_preds"].numpy())

    @torch.no_grad()
    def _forward_value(self, obs) -> np.ndarray:
        return self.module.forward_train(
            {"obs": torch.from_numpy(np.asarray(obs))})["vf_preds"].numpy()

    def ping(self) -> str:
        """Health probe for FaultTolerantActorManager."""
        return "pong"

    def torch_state(self) -> Dict[str, Any]:
        """What this runner's process holds of torch: whether CUDA was
        initialised in it, and its intra-op thread count."""
        return {"cuda_initialized": torch.cuda.is_initialized(),
                "num_threads": torch.get_num_threads()}

    # ---- weight sync (reference worker_set.py:365 sync_weights) -----
    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        self.module.load_state_dict(
            {k: torch.tensor(v) for k, v in weights.items()})
        self._has_weights = True

    def get_weights(self) -> Dict[str, np.ndarray]:
        return {k: v.numpy().copy()
                for k, v in self.module.state_dict().items()}

    # ---- sampling ---------------------------------------------------
    def sample(self, num_timesteps: int) -> Dict[str, Any]:
        """Roll out ~num_timesteps across the vector env; returns a
        fragment batch of stacked columns [T, num_envs, ...] plus
        bootstrap values and completed-episode metrics."""
        from ray_tpu_torch._private import spans as _spans
        with _spans.span("runner.sample", timesteps=num_timesteps):
            return self._sample_impl(num_timesteps)

    def _sample_impl(self, num_timesteps: int) -> Dict[str, Any]:
        assert self._has_weights, "set_weights before sample"
        steps = max(1, num_timesteps // self.env.num_envs)
        cols: Dict[str, List[np.ndarray]] = {
            "obs": [], "actions": [], "rewards": [], "terminateds": [],
            "truncateds": [], "action_logp": [], "vf_preds": [],
            "raw_rewards": []}
        # sparse (t, env) -> true final observation at done steps, for
        # replay-based algorithms that bootstrap at update time
        finals_idx: List[Tuple[int, int]] = []
        finals_val: List[np.ndarray] = []
        for step_t in range(steps):
            actions, logp, vf = self._forward_explore(self._obs)
            obs_next, rewards, terms, truncs, _, final_obs = \
                self.env.step(actions)
            raw_rewards = rewards.copy()
            for i in np.nonzero(np.asarray(terms) | np.asarray(truncs))[0]:
                if final_obs[i] is not None:
                    finals_idx.append((step_t, int(i)))
                    finals_val.append(np.asarray(final_obs[i]))
            # Truncation is not termination: fold the bootstrap value of
            # the true final observation into the reward (exactly
            # equivalent to bootstrapping V there), so GAE can then treat
            # done = term|trunc uniformly as episode end.
            trunc_idx = np.nonzero(np.asarray(truncs)
                                   & ~np.asarray(terms))[0]
            if trunc_idx.size:
                f_obs = np.stack([final_obs[i] for i in trunc_idx])
                v_fin = self._forward_value(f_obs)
                rewards = rewards.copy()
                rewards[trunc_idx] += self.gamma * v_fin
            cols["obs"].append(self._obs)
            cols["actions"].append(actions)
            cols["rewards"].append(rewards)
            cols["raw_rewards"].append(raw_rewards)
            cols["terminateds"].append(np.asarray(terms))
            cols["truncateds"].append(np.asarray(truncs))
            cols["action_logp"].append(logp)
            cols["vf_preds"].append(vf)

            self._ep_ret += rewards
            self._ep_len += 1
            done = np.asarray(terms) | np.asarray(truncs)
            for i in np.nonzero(done)[0]:
                self._completed.append({
                    "episode_return": float(self._ep_ret[i]),
                    "episode_len": int(self._ep_len[i]),
                    "lane": int(i)})
                self._ep_ret[i] = 0.0
                self._ep_len[i] = 0
            self._obs = obs_next

        batch = {k: np.stack(v) for k, v in cols.items()}  # [T, N, ...]
        # Fragment-end bootstrap: V(current obs). For envs whose last step
        # was done, this is the autoreset obs — GAE masks it with
        # (1 - done); truncation bootstrap was already folded into the
        # reward above.
        batch["bootstrap_value"] = self._forward_value(self._obs)
        # Obs after the final step: with obs[t+1], gives next_obs for
        # replay-based algorithms (done rows mask the autoreset obs).
        batch["last_obs"] = np.asarray(self._obs).copy()
        batch["final_obs_idx"] = (
            np.asarray(finals_idx, np.int64).reshape(-1, 2))
        batch["final_obs_vals"] = (
            np.stack(finals_val) if finals_val
            else np.zeros((0, *batch["last_obs"].shape[1:]),
                          batch["last_obs"].dtype))
        metrics = self._completed
        self._completed = []
        batch["episode_metrics"] = metrics
        batch["worker_index"] = self.worker_index
        return batch

    def stop(self) -> None:
        self.env.close()
