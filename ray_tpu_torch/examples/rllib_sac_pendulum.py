"""SAC on gymnasium's Pendulum-v1 (continuous control)."""

from ray_tpu_torch.rllib import SACConfig


def main(iterations=800, device=None):
    algo = (SACConfig()
            .environment("Pendulum-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=8)
            .training(lr=3e-4, buffer_size=50_000,
                      train_batch_size=256,
                      num_steps_sampled_before_learning_starts=1000)
            .rl_module(model_hiddens=(128, 128))
            .debugging(seed=0)
            .learners(device=device)
            .build())
    for i in range(iterations):
        result = algo.train()
        reward = result["episode_reward_mean"]
        if i % 40 == 0:
            alpha = result["learner"].get("alpha", float("nan"))
            print(f"iter {i:4d} reward {reward:8.1f} alpha {alpha:.3f}")
        if reward == reward and reward >= -250.0:
            print("solved at iter", i)
            break
    algo.stop()


if __name__ == "__main__":
    main()
