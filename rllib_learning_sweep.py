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
    python3 rllib_learning_sweep.py --algo bc --package ray_tpu_torch \
        --device cpu --seeds 0-4      # also pg, a2c, es, ma_ppo

Runs one algorithm once a seed, stopping once episode_reward_mean
reaches its bar: PPO CartPole at tests/test_rllib.py:114's config (150
within 40 iterations), IMPALA (--algo impala) at tests/test_rllib.py:139's
(2 runner actors, asynchronous, 150 within 250 iterations; the package's
runtime is started for it), DQN (--algo dqn) at
tests/test_rllib_offpolicy.py's test_dqn_cartpole_learns (150 within
1,000 iterations), SAC (--algo sac) at tests/test_rllib_sac.py's
test_sac_pendulum_learns (Pendulum-v1, -300 within 800) and TD3 (--algo
td3) at tests/test_rllib_pg_td3.py's test_td3_pendulum_learns (-300
within 900), PG (--algo pg) at tests/test_rllib_pg_td3.py's
test_pg_cartpole_learns (150 within 300), A2C (--algo a2c) at
tests/test_rl_round4.py's test_a2c_cartpole_learns (150; the test's
900 s deadline becomes A2C_ITERS iterations), BC (--algo bc) at
tests/test_rllib_offline.py's test_bc_learns_cartpole_from_expert_data
(4,000 steps of a hand-coded CartPole balancer recorded through
JsonWriter, then 120 within 30 iterations), ES (--algo es) at
tests/test_rllib_es.py's test_es_cartpole_learns (150 within 80) and
two-policy PPO (--algo ma_ppo) at tests/test_multi_agent.py's
test_two_policies_both_learn (both policies' mean return over an
iteration's episodes, at least 2 of them, at 150 within 60; its "best"
is the lower of the two). It runs on the JAX package (ray_tpu) or on the port
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
# A2C's learning test stops at a 900 s deadline, not a count: 1,000
# iterations of 1,024 steps
A2C_ITERS = 1000


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


def pg_cartpole_config(PGConfig, seed):
    """tests/test_rllib_pg_td3.py's PG CartPole config with `seed`: 8 envs
    at fragment 128, batch 1024, lr 4e-3, entropy 0.01, vf 0.5."""
    return (PGConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=128)
            .training(lr=4e-3, train_batch_size=1024, entropy_coeff=0.01,
                      vf_loss_coeff=0.5, gamma=0.99)
            .debugging(seed=seed))


def a2c_cartpole_config(A2CConfig, seed):
    """tests/test_rl_round4.py's A2C CartPole config with `seed`: 8 envs
    at fragment 64, batch 1024, lr 1e-3, entropy 0.01."""
    return (A2CConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .training(train_batch_size=1024, lr=1e-3, entropy_coeff=0.01,
                      vf_clip_param=10000.0)
            .debugging(seed=seed))


def es_cartpole_config(ESConfig, seed):
    """tests/test_rllib_es.py's ES CartPole config with `seed`: (32, 32),
    24 perturbations, sigma 0.1, lr 0.03, horizon 500."""
    return (ESConfig()
            .environment("CartPole-v1")
            .training(lr=0.03, sigma=0.1, num_perturbations=24,
                      episode_horizon=500)
            .rl_module(model_hiddens=(32, 32))
            .debugging(seed=seed))


def bc_cartpole_config(BCConfig, seed, data):
    """tests/test_rllib_offline.py's BC config with `seed`, reading the
    expert fragments under `data`: lr 5e-3, batch 2000, minibatch 256, 2
    epochs."""
    return (BCConfig()
            .environment("CartPole-v1")
            .offline_data(input_=data)
            .training(lr=5e-3, train_batch_size=2000, minibatch_size=256,
                      num_epochs=2)
            .debugging(seed=seed))


def marwil_cartpole_config(MARWILConfig, seed, data):
    """tests/test_rllib_offline.py's MARWIL config with `seed`: beta 1,
    lr 1e-3, batch 1000, minibatch 128."""
    return (MARWILConfig()
            .environment("CartPole-v1")
            .offline_data(input_=data)
            .training(lr=1e-3, beta=1.0, train_batch_size=1000,
                      minibatch_size=128)
            .debugging(seed=seed))


MA_ENV = "ma_cartpole_pp2"


def ma_ppo_config(PPOConfig, seed):
    """tests/test_multi_agent.py's two-policy config with `seed` (the
    test's own is 7): 2-agent CartPole, 4 envs at fragment 128, batch
    1024, minibatch 256, 10 epochs, pol_a for agent_0 and pol_b for
    agent_1. Registers the env in the config's package first."""
    import importlib
    rllib = importlib.import_module(
        PPOConfig.__module__.split(".rllib.")[0] + ".rllib")
    rllib.register_env(MA_ENV, rllib.make_multi_agent("CartPole-v1"))
    return (PPOConfig()
            .environment(MA_ENV, env_config={"num_agents": 2})
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=128)
            .training(lr=1e-3, train_batch_size=1024, minibatch_size=256,
                      num_epochs=10, entropy_coeff=0.01, gamma=0.99,
                      vf_clip_param=10000.0)
            .multi_agent(policies={"pol_a": None, "pol_b": None},
                         policy_mapping_fn=ma_policy)
            .debugging(seed=seed))


def ma_policy(agent_id):
    return "pol_a" if agent_id == "agent_0" else "pol_b"


def record_expert_data(package, path, timesteps=4000, seed=0):
    """tests/test_rllib_offline.py's _record_expert_data in `package`:
    a hand-coded CartPole balancer (push toward the falling side: logits
    +-8 (angle + 0.5 angular velocity)) on 4 envs, fragments of 200
    steps written through the package's JsonWriter until `timesteps`.
    Returns the mean return of its completed episodes."""
    import importlib

    import numpy as np
    catalog = importlib.import_module(package + ".rllib.core.catalog")
    runner_mod = importlib.import_module(package + ".rllib.env.env_runner")
    json_io = importlib.import_module(package + ".rllib.offline.json_io")
    if package == "ray_tpu":
        import jax
        import jax.numpy as jnp

        class Expert(catalog.DiscreteMLPModule):
            def forward_train(self, params, batch):
                obs = batch["obs"]
                score = obs[..., 2] + 0.5 * obs[..., 3]
                return {"action_dist_inputs": jnp.stack(
                            [-8.0 * score, 8.0 * score], axis=-1),
                        "vf_preds": jnp.zeros(obs.shape[:-1], jnp.float32)}
        module = Expert(4, 2)
        weights = module.init_params(jax.random.PRNGKey(0))
    else:
        import torch

        class Expert(catalog.DiscreteMLPModule):
            def forward_train(self, batch):
                obs = batch["obs"].float()
                score = obs[..., 2] + 0.5 * obs[..., 3]
                return {"action_dist_inputs": torch.stack(
                            [-8.0 * score, 8.0 * score], dim=-1),
                        "vf_preds": torch.zeros(obs.shape[:-1])}
        module = Expert(4, 2)
        weights = {k: v.numpy() for k, v in module.state_dict().items()}
    runner = runner_mod.SingleAgentEnvRunner(
        "CartPole-v1", module, num_envs=4, seed=seed, gamma=0.99)
    runner.set_weights(weights)
    writer = json_io.JsonWriter(path)
    returns, done = [], 0
    while done < timesteps:
        frag = runner.sample(200)
        writer.write(frag)
        done += frag["rewards"].size
        returns += [m["episode_return"] for m in frag["episode_metrics"]]
    writer.close()
    runner.stop()
    return float(np.mean(returns)) if returns else 0.0


# --algo -> (config maker, its config class's name, bar, iterations)
ALGOS = {
    "ppo": (cartpole_config, "PPOConfig", BAR, ITERS),
    "impala": (impala_cartpole_config, "ImpalaConfig", BAR, IMPALA_ITERS),
    "dqn": (dqn_cartpole_config, "DQNConfig", BAR, 1000),
    "sac": (sac_pendulum_config, "SACConfig", -300.0, 800),
    "td3": (td3_pendulum_config, "TD3Config", -300.0, 900),
    "pg": (pg_cartpole_config, "PGConfig", BAR, 300),
    "a2c": (a2c_cartpole_config, "A2CConfig", BAR, A2C_ITERS),
    "bc": (bc_cartpole_config, "BCConfig", 120.0, 30),
    "es": (es_cartpole_config, "ESConfig", BAR, 80),
    "ma_ppo": (ma_ppo_config, "PPOConfig", BAR, 60),
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


def learn_ma(config, bar, iters, inspect=None):
    """learn() for two-policy PPO, as tests/test_multi_agent.py's
    test_two_policies_both_learn reads it: each module's best mean
    return over an iteration's completed episodes on its lanes (at least
    2 of them). Returns (the lower of the two bests, iterations,
    inspect(algo) or None, {module: best})."""
    import numpy as np
    algo = config.build()
    try:
        runner = algo.env_runners._local
        lane_mod = list(runner._lane_module_ids)
        best = {m: float("-inf") for m in set(lane_mod)}
        sample = runner.sample

        def spy(n):
            frag = sample(n)
            per = {m: [] for m in best}
            for m in frag["episode_metrics"]:
                per[lane_mod[m["lane"]]].append(m["episode_return"])
            for mid, vals in per.items():
                if len(vals) >= 2:
                    best[mid] = max(best[mid], float(np.mean(vals)))
            return frag
        runner.sample = spy
        iterations = 0
        while iterations < iters and min(best.values()) < bar:
            algo.train()
            iterations += 1
        seen = inspect(algo) if inspect else None
    finally:
        algo.stop()
    return min(best.values()), iterations, seen, best


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
    data = None
    try:
        if args.algo == "bc":
            import tempfile
            data = tempfile.mkdtemp(prefix="sweep_expert_")
            expert = record_expert_data(args.package, data)
            print(f"expert data: mean return {expert:.2f}", flush=True)
        # the JAX package's rllib does not export every config class:
        # its registry has each one
        config_cls = getattr(rllib, config_name, None) or \
            rllib.get_algorithm_class(config_name[:-len("Config")],
                                      return_config=True)[1].__class__
        for seed in args.seeds:
            if data is not None:
                config = make(config_cls, seed, data)
            else:
                config = make(config_cls, seed)
            if args.package == "ray_tpu_torch":
                config.learners(device=args.device)
            t0 = time.perf_counter()
            if args.algo == "ma_ppo":
                best, iterations, _, per = learn_ma(config, bar, iters)
            else:
                best, iterations, _ = learn(config, bar, iters)
                per = None
            runs[seed] = {"best": best, "iterations": iterations,
                          "s": time.perf_counter() - t0}
            if per is not None:
                runs[seed]["by_module"] = per
            print(f"seed {seed}: best {best:.2f} in {iterations} iterations "
                  f"({runs[seed]['s']:.2f} s)", flush=True)
    finally:
        if args.algo == "impala":
            package.shutdown()
        if data is not None:
            import shutil
            shutil.rmtree(data, ignore_errors=True)
    reached = [s for s, r in runs.items() if r["best"] >= bar]
    print(json.dumps({"algo": args.algo, "package": args.package,
                      "device": args.device, "bar": bar,
                      "iterations": iters, "reached": reached,
                      "of": len(runs), "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
