from ray_tpu_torch.rllib.algorithms.td3.td3 import (TD3, DeterministicModule,
                                              TD3Config, TD3Learner)

__all__ = ["TD3", "TD3Config", "TD3Learner", "DeterministicModule"]
