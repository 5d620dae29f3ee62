from ray_tpu_torch.rllib.algorithms.ddpg.ddpg import DDPG, DDPGConfig

__all__ = ["DDPG", "DDPGConfig"]
