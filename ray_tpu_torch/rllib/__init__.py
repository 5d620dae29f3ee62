"""ray_tpu_torch.rllib: reinforcement learning on the port (all 14
algorithms of the JAX package's registry).

The port's counterpart of ray_tpu/rllib (reference: python/ray/rllib —
the Algorithm/Learner/RLModule/EnvRunner stack, SURVEY.md §2.3): the
Learner trains a torch RLModule on the card (or on the device its
config names), EnvRunners stay CPU actors streaming trajectories
through the object store (BASELINE.json north star). Algorithms: PPO,
IMPALA and APPO; the off-policy family over (prioritized) replay and the
sharded replay plane (DQN, SimpleQ, SAC, TD3, DDPG); PG and A2C; the
offline family over JSON fragments (MARWIL, BC, CQL); ES; multi-agent
PPO over a MultiAgentRLModule; connector pipelines at the runners.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rllib.algorithms.algorithm_config import \
    AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.a2c.a2c import A2C, A2CConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.cql.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.es.es import ES, ESConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.marwil.marwil import (BC, MARWIL,  # noqa: F401
                                                          BCConfig,
                                                          MARWILConfig)
from ray_tpu_torch.rllib.algorithms.pg.pg import PG, PGConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dqn.simple_q import (SimpleQ,  # noqa: F401
                                                         SimpleQConfig)
from ray_tpu_torch.rllib.algorithms.td3.td3 import TD3, TD3Config  # noqa: F401
from ray_tpu_torch.rllib.algorithms.ddpg.ddpg import DDPG, DDPGConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.sac.sac import SAC, SACConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.impala.impala import (Impala,  # noqa: F401
                                                          ImpalaConfig)
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.registry import (  # noqa: F401
    get_algorithm_class, registered_algorithms)
from ray_tpu_torch.rllib.core.catalog import (DiscreteConvModule,  # noqa: F401
                                              DiscreteMLPModule, flat_order,
                                              params_from_jax)
from ray_tpu_torch.rllib.core.learner import Learner  # noqa: F401
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.core.marl_module import MultiAgentRLModule  # noqa: F401
from ray_tpu_torch.rllib.core.rl_module import RLModule  # noqa: F401
from ray_tpu_torch.rllib.env.base import Env, make_env, register_env  # noqa: F401
from ray_tpu_torch.rllib.env import cartpole  # noqa: F401  (registers CartPole-v1)
from ray_tpu_torch.rllib.env import catch_pixels  # noqa: F401  (CatchPixels-v0)
from ray_tpu_torch.rllib.env import minipong  # noqa: F401  (MiniPong-v0)
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner  # noqa: F401
from ray_tpu_torch.rllib.env.multi_agent import (MultiAgentEnv,  # noqa: F401
                                                 make_multi_agent)

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "Impala",
    "ImpalaConfig", "APPO", "APPOConfig", "DQN", "DQNConfig", "SimpleQ",
    "SimpleQConfig", "SAC", "SACConfig", "TD3", "TD3Config", "DDPG",
    "DDPGConfig", "MARWIL", "MARWILConfig", "BC", "BCConfig", "ES",
    "ESConfig", "PG", "PGConfig", "A2C", "A2CConfig", "CQL", "CQLConfig",
    "MultiAgentRLModule", "flat_order",
    "get_algorithm_class", "registered_algorithms", "Learner",
    "LearnerGroup", "RLModule", "DiscreteMLPModule", "DiscreteConvModule",
    "params_from_jax", "Env", "register_env", "make_env",
    "SingleAgentEnvRunner", "MultiAgentEnv", "make_multi_agent",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('rllib')
del _rlu
