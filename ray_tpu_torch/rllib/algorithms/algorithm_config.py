"""AlgorithmConfig: config-as-object builder.

reference parity: rllib/algorithms/algorithm_config.py:118 — chained
.environment()/.env_runners()/.training()/.learners() setters returning
self, .build() producing the Algorithm. Only the knobs this stack
implements are exposed; unknown kwargs raise immediately (the reference
validates centrally too). The port's copy adds the learners' device:
learners(device=None) is the card, and building raises where there is
none; pass device="cpu" to learn on the CPU.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Type


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[Type] = None):
        self.algo_class = algo_class
        # environment
        self.env: Optional[str] = None
        self.env_config: Dict[str, Any] = {}
        # env runners (reference .env_runners / legacy .rollouts)
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 200
        # connector pipelines (reference connectors/): vectorized
        # obs/reward transforms + action transforms at the runner
        # boundary; instances are templates — each runner gets its own
        # (pickled) copy of the stateful ones
        self.env_connectors: list = []
        self.action_connectors: list = []
        # training
        self.lr: float = 5e-5
        self.gamma: float = 0.99
        self.lambda_: float = 0.95
        self.train_batch_size: int = 4000
        self.minibatch_size: Optional[int] = 128
        self.num_epochs: int = 30           # reference num_sgd_iter
        self.grad_clip: Optional[float] = None
        self.entropy_coeff: float = 0.0
        self.vf_loss_coeff: float = 1.0
        # learners: None is the card (raises without one), else a torch
        # device ("cpu", "cuda")
        self.num_learners: int = 0
        self.learner_device: Optional[str] = None
        # module
        self.model_hiddens = (64, 64)
        self._custom_module = None
        # offline data (reference .offline_data(input_=..., output=...))
        self.input_: Optional[str] = None
        self.output: Optional[str] = None
        # multi-agent (reference .multi_agent(policies=...,
        # policy_mapping_fn=...); None => single-policy)
        self.policies = None
        self.policy_mapping_fn = None
        # misc
        self.seed: int = 0
        self.metrics_num_episodes_for_smoothing: int = 100

    # ---- chained setters -------------------------------------------
    def environment(self, env: Optional[str] = None,
                    env_config: Optional[Dict[str, Any]] = None
                    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    env_connectors: Optional[list] = None,
                    action_connectors: Optional[list] = None
                    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_connectors is not None:
            self.env_connectors = list(env_connectors)
        if action_connectors is not None:
            self.action_connectors = list(action_connectors)
        return self

    def training(self, **kwargs: Any) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def learners(self, num_learners: Optional[int] = None,
                 device: Optional[str] = None) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.learner_device = str(device)
        return self

    def rl_module(self, module=None, model_hiddens=None
                  ) -> "AlgorithmConfig":
        if module is not None:
            self._custom_module = module
        if model_hiddens is not None:
            self.model_hiddens = tuple(model_hiddens)
        return self

    def multi_agent(self, policies=None, policy_mapping_fn=None
                    ) -> "AlgorithmConfig":
        """Distinct per-agent policies (reference
        algorithm_config.py .multi_agent). `policies`: dict
        {module_id: RLModule-or-None} (None => default module built from
        the env's spaces); `policy_mapping_fn(agent_id) -> module_id`
        routes each fixed-roster agent to its module."""
        if policies is not None:
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def offline_data(self, input_: Optional[str] = None,
                     output: Optional[str] = None) -> "AlgorithmConfig":
        """input_: dir of JsonWriter shards to train from (BC/MARWIL);
        output: dir to write sampled fragments to (any algorithm)."""
        if input_ is not None:
            self.input_ = input_
        if output is not None:
            self.output = output
        return self

    def debugging(self, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    # ---- build ------------------------------------------------------
    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self, env: Optional[str] = None):
        if env is not None:
            self.env = env
        if self.algo_class is None:
            raise ValueError("config has no algo_class to build")
        return self.algo_class(self.copy())
