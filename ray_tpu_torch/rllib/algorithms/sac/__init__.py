from ray_tpu_torch.rllib.algorithms.sac.sac import (SAC, SACConfig, SACLearner,
                                              SquashedGaussianModule)

__all__ = ["SAC", "SACConfig", "SACLearner", "SquashedGaussianModule"]
