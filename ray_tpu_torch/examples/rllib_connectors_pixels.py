"""Connector pipelines: DeepMind preprocessing without env wrappers.

reference parity: rllib/connectors/ — the raw 168x168x3 MiniPong env
feeds PPO through a connector pipeline (grayscale-resize → frame-stack
→ reward-clip) attached via config instead of baked-in wrappers; the
module builds against the pipeline's output space [84, 84, 4].

Run:
    python -m ray_tpu_torch.examples.rllib_connectors_pixels
"""

from ray_tpu_torch.rllib import PPOConfig
from ray_tpu_torch.rllib.connectors import deepmind_connectors


def main(iterations=5, device=None) -> None:
    algo = (PPOConfig()
            .environment("MiniPongRaw-v0")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=32,
                         env_connectors=deepmind_connectors())
            .training(lr=5e-4, train_batch_size=256, minibatch_size=128,
                      num_epochs=2, entropy_coeff=0.02)
            .debugging(seed=0)
            .learners(device=device)
            .build())
    print("module observation space:", algo.observation_space.shape)
    for i in range(iterations):
        result = algo.train()
        print(f"iter {i} trained={result['num_env_steps_trained']} "
              f"return={result['episode_reward_mean']:.2f}")
    algo.stop()


if __name__ == "__main__":
    main()
