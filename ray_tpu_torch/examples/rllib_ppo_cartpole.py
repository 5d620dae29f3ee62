"""PPO on CartPole to 150+ mean reward, with save/restore."""

import tempfile

from ray_tpu_torch.rllib import PPOConfig


def main(iterations=40, device=None):
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=128)
            .training(lr=1e-3, train_batch_size=1024,
                      minibatch_size=256, num_epochs=10,
                      entropy_coeff=0.01, vf_clip_param=10000.0)
            .debugging(seed=7)
            .learners(device=device)
            .build())
    for i in range(iterations):
        result = algo.train()
        reward = result["episode_reward_mean"]
        print(f"iter {i:3d} reward {reward:7.1f}")
        if reward >= 150.0:
            break
    ckpt = algo.save(tempfile.mkdtemp(prefix="ppo_ckpt_"))
    print("checkpoint:", ckpt)
    algo.stop()


if __name__ == "__main__":
    main()
