"""ray_tpu_torch.rllib: reinforcement learning on the port (PPO, IMPALA
and APPO so far).

The port's counterpart of ray_tpu/rllib (reference: python/ray/rllib —
the Algorithm/Learner/RLModule/EnvRunner stack, SURVEY.md §2.3): the
Learner trains a torch RLModule on the card (or on the device its
config names), EnvRunners stay CPU actors streaming trajectories
through the object store (BASELINE.json north star). Ported so far:
PPO, IMPALA and APPO, local and over a torch.distributed learner gang;
the JAX package's other algorithms raise, naming their ROADMAP rows.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rllib.algorithms.algorithm_config import \
    AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.impala.impala import (Impala,  # noqa: F401
                                                          ImpalaConfig)
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.registry import (  # noqa: F401
    get_algorithm_class, registered_algorithms)
from ray_tpu_torch.rllib.core.catalog import (DiscreteConvModule,  # noqa: F401
                                              DiscreteMLPModule,
                                              params_from_jax)
from ray_tpu_torch.rllib.core.learner import Learner  # noqa: F401
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.core.rl_module import RLModule  # noqa: F401
from ray_tpu_torch.rllib.env.base import Env, make_env, register_env  # noqa: F401
from ray_tpu_torch.rllib.env import cartpole  # noqa: F401  (registers CartPole-v1)
from ray_tpu_torch.rllib.env import minipong  # noqa: F401  (MiniPong-v0)
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner  # noqa: F401
from ray_tpu_torch.rllib.env.multi_agent import (MultiAgentEnv,  # noqa: F401
                                                 make_multi_agent)

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "Impala",
    "ImpalaConfig", "APPO", "APPOConfig",
    "get_algorithm_class", "registered_algorithms", "Learner",
    "LearnerGroup", "RLModule", "DiscreteMLPModule", "DiscreteConvModule",
    "params_from_jax", "Env", "register_env", "make_env",
    "SingleAgentEnvRunner", "MultiAgentEnv", "make_multi_agent",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('rllib')
del _rlu
