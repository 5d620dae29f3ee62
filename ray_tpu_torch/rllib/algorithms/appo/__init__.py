from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig  # noqa: F401

__all__ = ["APPO", "APPOConfig"]
