"""Algorithm base + EnvRunnerSet.

The port's counterpart of ray_tpu/rllib/algorithms/algorithm.py
(reference parity: rllib/algorithms/algorithm.py:192,555,816 — Algorithm
(a Tune Trainable) whose train() runs one training_step() and folds
env-runner episode metrics into the result; WorkerSet
(evaluation/worker_set.py:82) with sync_weights (:365) and parallel
foreach (:657) becomes EnvRunnerSet here (local runner when
num_env_runners=0, CPU actor runners otherwise). The learners run on the
config's learner_device (the card by default); the runners always run
on the CPU. With config.output set, every sampled fragment is written
through a JsonWriter; the env pipeline's state (connectors) is saved and
restored with the algorithm.
"""

from __future__ import annotations

import collections
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.catalog import default_module_for
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.env.base import make_env
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

class EnvRunnerSet:
    """Local or actor-based rollout workers (reference WorkerSet)."""

    def __init__(self, config: AlgorithmConfig, module):
        self.config = config
        self._local: Optional[SingleAgentEnvRunner] = None
        self._actors: List[Any] = []
        self._writer = None
        if config.output:
            from ray_tpu_torch.rllib.offline.json_io import JsonWriter
            self._writer = JsonWriter(config.output)
        if config.num_env_runners == 0:
            self._local = SingleAgentEnvRunner(
                config.env, module, config.env_config,
                num_envs=config.num_envs_per_env_runner,
                seed=config.seed, worker_index=0, gamma=config.gamma,
                policy_mapping_fn=config.policy_mapping_fn,
                env_connectors=config.env_connectors,
                action_connectors=config.action_connectors)
        else:
            import ray_tpu_torch
            runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
            self._actors = [
                runner_cls.options(num_cpus=1).remote(
                    config.env, module, config.env_config,
                    num_envs=config.num_envs_per_env_runner,
                    seed=config.seed, worker_index=i + 1,
                    gamma=config.gamma,
                    policy_mapping_fn=config.policy_mapping_fn,
                    env_connectors=config.env_connectors,
                    action_connectors=config.action_connectors)
                for i in range(config.num_env_runners)
            ]

    def __len__(self) -> int:
        return max(1, len(self._actors))

    def sync_weights(self, weights) -> None:
        """reference worker_set.py:365."""
        if self._local is not None:
            self._local.set_weights(weights)
            return
        import ray_tpu_torch
        ray_tpu_torch.get([a.set_weights.remote(weights)
                           for a in self._actors], timeout=300)

    def set_explore_inputs(self, inputs: Dict[str, float]) -> None:
        """Broadcast exploration scalars (epsilon schedules etc.)."""
        if self._local is not None:
            self._local.set_explore_inputs(inputs)
            return
        import ray_tpu_torch
        ray_tpu_torch.get([a.set_explore_inputs.remote(inputs)
                           for a in self._actors], timeout=120)

    def sample_sync(self, num_timesteps_per_runner: int
                    ) -> List[Dict[str, Any]]:
        """reference execution/rollout_ops.py:21
        synchronous_parallel_sample."""
        if self._local is not None:
            frags = [self._local.sample(num_timesteps_per_runner)]
        else:
            import ray_tpu_torch
            frags = ray_tpu_torch.get(
                [a.sample.remote(num_timesteps_per_runner)
                 for a in self._actors], timeout=600)
        if self._writer is not None:
            for f in frags:
                self._writer.write(f)
        return frags

    def get_connector_states(self) -> List[Any]:
        """Each runner's env-pipeline state, in runner order."""
        if self._local is not None:
            return [self._local.get_connector_state()]
        import ray_tpu_torch
        return ray_tpu_torch.get([a.get_connector_state.remote()
                                  for a in self._actors], timeout=120)

    def set_connector_states(self, states: List[Any]) -> None:
        if self._local is not None:
            self._local.set_connector_state(states[0])
            return
        import ray_tpu_torch
        ray_tpu_torch.get([a.set_connector_state.remote(s)
                           for a, s in zip(self._actors, states)],
                          timeout=120)

    @property
    def actors(self) -> List[Any]:
        return self._actors

    def stop(self) -> None:  # EnvRunnerSet
        if self._writer is not None:
            self._writer.close()
        if self._local is not None:
            self._local.stop()
        import ray_tpu_torch
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001 - actor already dead
                pass


class Algorithm:
    """Subclasses implement training_step(); train() wraps one step with
    metrics/timing (reference algorithm.py:816 step →
    _run_one_training_iteration :3020)."""

    learner_cls = None  # set by subclass
    ma_learner_cls = None  # multi-agent variant (PPO sets it)
    needs_env_runners = True  # ES overrides: no rollout workers

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        if config.env is None:
            raise ValueError("config.environment(env=...) is required")
        probe = make_env(config.env, config.env_config)
        self.observation_space = probe.observation_space
        self.action_space = probe.action_space
        if config.env_connectors:
            # the module acts on the PIPELINE's output space
            from ray_tpu_torch.rllib.connectors import ConnectorPipeline
            self.observation_space = ConnectorPipeline(
                config.env_connectors).observation_space(
                    self.observation_space)
        probe.close()

        if config.policies:
            # distinct per-agent policies (reference marl_module.py:40)
            from ray_tpu_torch.rllib.core.marl_module import \
                MultiAgentRLModule
            if config.policy_mapping_fn is None:
                raise ValueError(
                    "multi_agent(policies=...) needs a policy_mapping_fn")
            if self.ma_learner_cls is None:
                raise ValueError(
                    f"{type(self).__name__} has no multi-agent learner")
            agents = getattr(probe, "agents", None)
            if agents:
                mapped = {config.policy_mapping_fn(a) for a in agents}
                unused = set(config.policies) - mapped
                if unused:
                    raise ValueError(
                        f"policies {sorted(unused)} are never produced "
                        f"by policy_mapping_fn for agents {agents}")
            self.module = MultiAgentRLModule({
                mid: (mod or self.default_module(
                    self.observation_space, self.action_space))
                for mid, mod in config.policies.items()})
            learner_cls = self.ma_learner_cls
        else:
            self.module = config._custom_module or self.default_module(
                self.observation_space, self.action_space)
            learner_cls = self.learner_cls
        # the learners first: without the device they need, nothing else
        # is started
        self.learner_group = LearnerGroup(
            functools.partial(learner_cls, self.module, self.config),
            num_learners=config.num_learners, seed=config.seed)
        if self.needs_env_runners:
            self.env_runners = EnvRunnerSet(config, self.module)
            self.env_runners.sync_weights(self.learner_group.get_weights())
        else:  # derivative-free algorithms (ES) evaluate their own way
            self.env_runners = None

        self._iteration = 0
        self._timesteps_total = 0
        self._episode_returns = collections.deque(
            maxlen=config.metrics_num_episodes_for_smoothing)
        self._episode_lens = collections.deque(
            maxlen=config.metrics_num_episodes_for_smoothing)

    # ---- the per-algorithm core ------------------------------------
    def default_module(self, observation_space, action_space):
        """Module when the user supplies none."""
        return default_module_for(observation_space, action_space,
                                  self.config.model_hiddens)

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # ---- public loop ------------------------------------------------
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        self._iteration += 1
        step_results = self.training_step()
        result = {
            "training_iteration": self._iteration,
            "num_env_steps_sampled_lifetime": self._timesteps_total,
            "time_this_iter_s": time.perf_counter() - t0,
            "env_runners": {
                "episode_return_mean": (
                    float(np.mean(self._episode_returns))
                    if self._episode_returns else float("nan")),
                "episode_len_mean": (
                    float(np.mean(self._episode_lens))
                    if self._episode_lens else float("nan")),
                "num_episodes": len(self._episode_returns),
            },
            **step_results,
        }
        # legacy-name aliases (reference keeps both during migration)
        result["episode_reward_mean"] = \
            result["env_runners"]["episode_return_mean"]
        return result

    def _record_episode_metrics(self, batches: List[Dict[str, Any]]
                                ) -> None:
        for b in batches:
            for m in b.get("episode_metrics", []):
                self._episode_returns.append(m["episode_return"])
                self._episode_lens.append(m["episode_len"])

    def _extra_state(self) -> Dict[str, Any]:
        """Algorithm-specific driver state to checkpoint (target-sync
        counters ...); subclasses extend."""
        return {}

    def _restore_extra_state(self, extra: Dict[str, Any]) -> None:
        pass

    # ---- checkpointing (Trainable contract: save/restore) -----------
    def save(self, checkpoint_dir: str) -> str:
        import os
        import pickle
        os.makedirs(checkpoint_dir, exist_ok=True)
        state = {
            "learner": self.learner_group.get_state(),
            "iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
            "extra": self._extra_state(),
        }
        if self.env_runners is not None and self.config.env_connectors:
            state["connectors"] = self.env_runners.get_connector_states()
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        import os
        import pickle
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self._iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]
        self._restore_extra_state(state.get("extra", {}))
        if self.env_runners is not None:
            if "connectors" in state:
                self.env_runners.set_connector_states(state["connectors"])
            self.env_runners.sync_weights(self.learner_group.get_weights())

    def stop(self) -> None:
        if self.env_runners is not None:
            self.env_runners.stop()
        self.learner_group.shutdown()
