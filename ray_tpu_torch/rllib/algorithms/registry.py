"""Algorithm registry (reference rllib/algorithms/registry.py).

The port's counterpart of ray_tpu/rllib/algorithms/registry.py, which
registers 14 algorithms. PPO, IMPALA and APPO are ported so far; the JAX
package's other names raise NotImplementedError naming their ROADMAP
rows, so `get_algorithm_class("PPO")` and lookups by name keep one
surface.
"""

from __future__ import annotations

from typing import Tuple

# the JAX package's other registered algorithms -> their ROADMAP rows
UNPORTED = {
    **{name: "Queue 1 item 6, 'the other algorithms'"
       for name in ("DQN", "SIMPLEQ", "SAC", "TD3", "DDPG", "CQL", "MARWIL",
                    "BC", "ES", "PG", "A2C")},
}


def _registry():
    from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig
    from ray_tpu_torch.rllib.algorithms.impala.impala import (Impala,
                                                              ImpalaConfig)
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig
    return {"PPO": (PPO, PPOConfig), "IMPALA": (Impala, ImpalaConfig),
            "APPO": (APPO, APPOConfig)}


def get_algorithm_class(name: str, return_config: bool = False):
    """reference registry.py get_algorithm_class."""
    row = UNPORTED.get(name.upper())
    if row is not None:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP {row}")
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
