from ray_tpu_torch.rllib.algorithms.dqn.dqn import (DQN, DQNConfig, DQNLearner,
                                              DuelingQMLPModule)

__all__ = ["DQN", "DQNConfig", "DQNLearner", "DuelingQMLPModule"]
