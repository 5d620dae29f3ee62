"""Multi-agent training with DISTINCT per-agent policies.

reference parity: rllib/core/rl_module/marl_module.py:40
(MultiAgentRLModule) + AlgorithmConfig.multi_agent(policies=...,
policy_mapping_fn=...). Two independently-parameterized PPO policies
train against one two-agent env; per-module losses sum inside ONE
scanned jitted update over the union params pytree.

Run:
    python -m ray_tpu_torch.examples.rllib_multi_agent_policies
"""

from ray_tpu_torch.rllib import PPOConfig, make_multi_agent, register_env


def main(iterations=20, device=None) -> None:
    register_env("ma_cartpole", make_multi_agent("CartPole-v1"))
    algo = (PPOConfig()
            .environment("ma_cartpole", env_config={"num_agents": 2})
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=128)
            .training(lr=1e-3, train_batch_size=1024,
                      minibatch_size=256, num_epochs=10,
                      entropy_coeff=0.01, vf_clip_param=10000.0)
            .multi_agent(
                policies={"left": None, "right": None},
                policy_mapping_fn=lambda aid:
                    "left" if aid == "agent_0" else "right")
            .debugging(seed=0)
            .learners(device=device)
            .build())
    for i in range(iterations):
        result = algo.train()
        stats = result["learner"]
        print(f"iter {i:2d} return={result['episode_reward_mean']:7.2f} "
              f"left_loss={stats.get('left/policy_loss', 0):+.4f} "
              f"right_loss={stats.get('right/policy_loss', 0):+.4f}")
    algo.stop()


if __name__ == "__main__":
    main()
