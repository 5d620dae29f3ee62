#!/usr/bin/env python3
"""CartPole's learning bar over many seeds, on one package.

    python3 rllib_learning_sweep.py --package ray_tpu_torch --device cpu \
        --seeds 0-39
    JAX_PLATFORMS=cpu python3 rllib_learning_sweep.py --package ray_tpu \
        --seeds 0-39
    python3 rllib_learning_sweep.py --algo impala --package ray_tpu_torch \
        --device cpu --seeds 0-19

Runs CartPole once a seed, stopping once episode_reward_mean reaches 150:
PPO at tests/test_rllib.py:114's config (at most 40 iterations), or
IMPALA (--algo impala) at tests/test_rllib.py:139's (2 runner actors,
asynchronous, at most 250 iterations; the package's runtime is started
for it). It runs on the JAX package (ray_tpu) or on the port
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


def learn_cartpole(config, inspect=None, iters=ITERS):
    """Trains `config`'s algorithm until episode_reward_mean reaches BAR,
    for at most `iters` iterations. Returns the best episode_reward_mean
    (the first iteration's may be nan), the iterations run, and
    inspect(algo) taken before the algorithm stops (None without it)."""
    algo = config.build()
    try:
        best, iterations = 0.0, 0
        while iterations < iters and best < BAR:
            best = max(best, algo.train()["episode_reward_mean"])
            iterations += 1
        seen = inspect(algo) if inspect else None
    finally:
        algo.stop()
    return best, iterations, seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", choices=("ppo", "impala"), default="ppo")
    ap.add_argument("--package", choices=("ray_tpu", "ray_tpu_torch"),
                    required=True)
    ap.add_argument("--device", default=None,
                    help="the port's learner device (default: the card)")
    ap.add_argument("--seeds", type=seeds, default=seeds("0-9"),
                    help="a seed or a range, e.g. 0-39")
    args = ap.parse_args(argv)
    package = importlib.import_module(args.package)
    rllib = importlib.import_module(args.package + ".rllib")
    if args.algo == "impala":
        make, iters = impala_cartpole_config, IMPALA_ITERS
        algo_config = rllib.ImpalaConfig
        package.init(num_cpus=3)
    else:
        make, iters = cartpole_config, ITERS
        algo_config = rllib.PPOConfig
    runs = {}
    try:
        for seed in args.seeds:
            config = make(algo_config, seed)
            if args.package == "ray_tpu_torch":
                config.learners(device=args.device)
            t0 = time.perf_counter()
            best, iterations, _ = learn_cartpole(config, iters=iters)
            runs[seed] = {"best": best, "iterations": iterations}
            print(f"seed {seed}: best {best:.2f} in {iterations} iterations "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
    finally:
        if args.algo == "impala":
            package.shutdown()
    reached = [s for s, r in runs.items() if r["best"] >= BAR]
    print(json.dumps({"algo": args.algo, "package": args.package,
                      "device": args.device, "reached": reached,
                      "of": len(runs), "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
