#!/usr/bin/env python3
"""A learning bar over many seeds, on one package.

    python3 rllib_learning_sweep.py --package ray_tpu_torch --device cpu \
        --seeds 0-39
    JAX_PLATFORMS=cpu python3 rllib_learning_sweep.py --package ray_tpu \
        --seeds 0-39
    python3 rllib_learning_sweep.py --algo impala --package ray_tpu_torch \
        --device cpu --seeds 0-19
    python3 rllib_learning_sweep.py --algo sac --package ray_tpu_torch \
        --device cpu --seeds 0-4

Runs one algorithm once a seed, stopping once episode_reward_mean
reaches its bar: PPO CartPole at tests/test_rllib.py:114's config (150
within 40 iterations), IMPALA (--algo impala) at tests/test_rllib.py:139's
(2 runner actors, asynchronous, 150 within 250 iterations; the package's
runtime is started for it), DQN (--algo dqn) at
tests/test_rllib_offpolicy.py's test_dqn_cartpole_learns (150 within
1,000 iterations), SAC (--algo sac) at tests/test_rllib_sac.py's
test_sac_pendulum_learns (Pendulum-v1, -300 within 800) and TD3 (--algo
td3) at tests/test_rllib_pg_td3.py's test_td3_pendulum_learns (-300
within 900). It runs on the JAX package (ray_tpu) or on the port
(ray_tpu_torch, its learner on --device: the card unless "cpu" is
given), importing only that package. Prints a line a seed, then one
JSON object: the seeds that reached the bar, and each seed's best
episode_reward_mean and iterations. The bar at a single seed is a draw;
this says how often each package clears it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time

ITERS, BAR = 40, 150.0
IMPALA_ITERS = 250


def seeds(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def cartpole_config(PPOConfig, seed):
    """tests/test_rllib.py:114's PPO CartPole config with `seed`, built
    from either package's PPOConfig (the learner where the package puts
    it: the port's on the card)."""
    return (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=128)
            .training(lr=1e-3, train_batch_size=1024, minibatch_size=256,
                      num_epochs=10, entropy_coeff=0.01, gamma=0.99,
                      vf_clip_param=10000.0)
            .debugging(seed=seed))


def impala_cartpole_config(ImpalaConfig, seed):
    """tests/test_rllib.py:139's IMPALA CartPole config with `seed`, built
    from either package's ImpalaConfig: 2 runner actors of 4 envs,
    fragments of 64, the async learner thread."""
    return (ImpalaConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(lr=2e-3, entropy_coeff=0.005, gamma=0.99,
                      grad_clip=40.0)
            .debugging(seed=seed))


def dqn_cartpole_config(DQNConfig, seed):
    """tests/test_rllib_offpolicy.py's DQN CartPole learning config with
    `seed`: the local runner with 8 envs, fragment 4, lr 1e-3, buffer
    50,000, batch 32, training intensity 8, learning from 1,000 steps, a
    target sync every 500, epsilon to 0.02 over 5,000 steps, n-step 3."""
    return (DQNConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=4)
            .training(lr=1e-3, buffer_size=50_000, train_batch_size=32,
                      training_intensity=8.0,
                      num_steps_sampled_before_learning_starts=1000,
                      target_network_update_freq=500,
                      epsilon_timesteps=5000, final_epsilon=0.02,
                      n_step=3, gamma=0.99)
            .debugging(seed=seed))


def sac_pendulum_config(SACConfig, seed):
    """tests/test_rllib_sac.py's SAC Pendulum learning config with
    `seed`: 4 envs at fragment 8, batch 256, buffer 50,000, (128, 128)."""
    return (SACConfig()
            .environment("Pendulum-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=8)
            .training(lr=3e-4, buffer_size=50_000, train_batch_size=256,
                      num_steps_sampled_before_learning_starts=1000,
                      gamma=0.99)
            .rl_module(model_hiddens=(128, 128))
            .debugging(seed=seed))


def td3_pendulum_config(TD3Config, seed):
    """tests/test_rllib_pg_td3.py's TD3 Pendulum config with `seed`: 4
    envs at fragment 8, batch 100, buffer 50,000, (128, 128)."""
    return (TD3Config()
            .environment("Pendulum-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=8)
            .training(lr=1e-3, buffer_size=50_000, train_batch_size=100,
                      num_steps_sampled_before_learning_starts=1000,
                      exploration_noise=0.1, gamma=0.99)
            .rl_module(model_hiddens=(128, 128))
            .debugging(seed=seed))


# --algo -> (config maker, its config class's name, bar, iterations)
ALGOS = {
    "ppo": (cartpole_config, "PPOConfig", BAR, ITERS),
    "impala": (impala_cartpole_config, "ImpalaConfig", BAR, IMPALA_ITERS),
    "dqn": (dqn_cartpole_config, "DQNConfig", BAR, 1000),
    "sac": (sac_pendulum_config, "SACConfig", -300.0, 800),
    "td3": (td3_pendulum_config, "TD3Config", -300.0, 900),
}


def learn(config, bar, iters, inspect=None):
    """Trains `config`'s algorithm until episode_reward_mean reaches
    `bar`, for at most `iters` iterations. Returns the best
    episode_reward_mean (-inf until an episode has ended), the iterations
    run, and inspect(algo) taken before the algorithm stops (None without
    it)."""
    algo = config.build()
    try:
        best, iterations = float("-inf"), 0
        while iterations < iters and best < bar:
            erm = algo.train()["episode_reward_mean"]
            if erm == erm:  # not nan
                best = max(best, erm)
            iterations += 1
        seen = inspect(algo) if inspect else None
    finally:
        algo.stop()
    return best, iterations, seen


def learn_cartpole(config, inspect=None, iters=ITERS):
    """learn() to CartPole's BAR."""
    return learn(config, BAR, iters, inspect)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", choices=tuple(ALGOS), default="ppo")
    ap.add_argument("--package", choices=("ray_tpu", "ray_tpu_torch"),
                    required=True)
    ap.add_argument("--device", default=None,
                    help="the port's learner device (default: the card)")
    ap.add_argument("--seeds", type=seeds, default=seeds("0-9"),
                    help="a seed or a range, e.g. 0-39")
    args = ap.parse_args(argv)
    package = importlib.import_module(args.package)
    rllib = importlib.import_module(args.package + ".rllib")
    make, config_name, bar, iters = ALGOS[args.algo]
    if args.algo == "impala":
        package.init(num_cpus=3)
    runs = {}
    try:
        for seed in args.seeds:
            config = make(getattr(rllib, config_name), seed)
            if args.package == "ray_tpu_torch":
                config.learners(device=args.device)
            t0 = time.perf_counter()
            best, iterations, _ = learn(config, bar, iters)
            runs[seed] = {"best": best, "iterations": iterations,
                          "s": time.perf_counter() - t0}
            print(f"seed {seed}: best {best:.2f} in {iterations} iterations "
                  f"({runs[seed]['s']:.2f} s)", flush=True)
    finally:
        if args.algo == "impala":
            package.shutdown()
    reached = [s for s, r in runs.items() if r["best"] >= bar]
    print(json.dumps({"algo": args.algo, "package": args.package,
                      "device": args.device, "bar": bar,
                      "iterations": iters, "reached": reached,
                      "of": len(runs), "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
