"""Offline RL: record expert data, then behavior-clone from it."""

import tempfile

from ray_tpu_torch.rllib import BCConfig, PPOConfig


def main(collect_iterations=15, bc_iterations=30, device=None):
    data_dir = tempfile.mkdtemp(prefix="offline_data_")

    # phase 1: collect data with a (briefly trained) PPO policy,
    # recording every sampled fragment via config.offline_data(output=)
    collector = (PPOConfig()
                 .environment("CartPole-v1")
                 .env_runners(num_envs_per_env_runner=8,
                              rollout_fragment_length=128)
                 .training(lr=1e-3, train_batch_size=1024,
                           minibatch_size=256, num_epochs=10,
                           entropy_coeff=0.01, vf_clip_param=10000.0)
                 .offline_data(output=data_dir)
                 .debugging(seed=7)
                 .learners(device=device)
                 .build())
    for i in range(collect_iterations):
        r = collector.train()
    print("collector reward:", round(r["episode_reward_mean"], 1))
    collector.stop()

    # phase 2: behavior-clone purely from the recorded fragments
    bc = (BCConfig()
          .environment("CartPole-v1")     # spaces + periodic eval only
          .offline_data(input_=data_dir)
          .training(lr=5e-3, train_batch_size=2000,
                    minibatch_size=256, num_epochs=2)
          .debugging(seed=0)
          .learners(device=device)
          .build())
    for i in range(bc_iterations):
        r = bc.train()
        erm = r["episode_reward_mean"]
        if i % 10 == 0:
            print(f"bc iter {i:2d} eval reward "
                  f"{erm if erm == erm else float('nan'):7.1f}")
    bc.stop()


if __name__ == "__main__":
    main()
