from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig, PPOLearner  # noqa: F401
