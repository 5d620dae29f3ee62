"""Algorithm registry (reference rllib/algorithms/registry.py).

The port's counterpart of ray_tpu/rllib/algorithms/registry.py: the same
14 names (the north-star set — PPO, IMPALA, APPO — plus the
value-learning (DQN/SimpleQ/SAC/TD3/DDPG/CQL), on-policy (PG/A2C),
derivative-free (ES) and offline (BC/MARWIL/CQL) families) behind the
same lookup surface, so `get_algorithm_class("PPO")` and lookups by name
work.
"""

from __future__ import annotations

from typing import Tuple


def _registry():
    from ray_tpu_torch.rllib.algorithms.a2c.a2c import A2C, A2CConfig
    from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig
    from ray_tpu_torch.rllib.algorithms.cql.cql import CQL, CQLConfig
    from ray_tpu_torch.rllib.algorithms.ddpg.ddpg import DDPG, DDPGConfig
    from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig
    from ray_tpu_torch.rllib.algorithms.dqn.simple_q import (SimpleQ,
                                                             SimpleQConfig)
    from ray_tpu_torch.rllib.algorithms.es.es import ES, ESConfig
    from ray_tpu_torch.rllib.algorithms.impala.impala import (Impala,
                                                              ImpalaConfig)
    from ray_tpu_torch.rllib.algorithms.marwil.marwil import (
        BC, MARWIL, BCConfig, MARWILConfig)
    from ray_tpu_torch.rllib.algorithms.pg.pg import PG, PGConfig
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig
    from ray_tpu_torch.rllib.algorithms.sac.sac import SAC, SACConfig
    from ray_tpu_torch.rllib.algorithms.td3.td3 import TD3, TD3Config
    return {"PPO": (PPO, PPOConfig), "IMPALA": (Impala, ImpalaConfig),
            "APPO": (APPO, APPOConfig), "DQN": (DQN, DQNConfig),
            "SAC": (SAC, SACConfig), "MARWIL": (MARWIL, MARWILConfig),
            "BC": (BC, BCConfig), "ES": (ES, ESConfig),
            "PG": (PG, PGConfig), "TD3": (TD3, TD3Config),
            "DDPG": (DDPG, DDPGConfig), "A2C": (A2C, A2CConfig),
            "SIMPLEQ": (SimpleQ, SimpleQConfig), "CQL": (CQL, CQLConfig)}


def get_algorithm_class(name: str, return_config: bool = False):
    """reference registry.py get_algorithm_class."""
    entry = _registry().get(name.upper())
    if entry is None:
        raise ValueError(
            f"unknown algorithm {name!r}; available: "
            f"{sorted(_registry())}")
    algo, config = entry
    if return_config:
        return algo, config()
    return algo


def registered_algorithms() -> Tuple[str, ...]:
    return tuple(sorted(_registry()))
