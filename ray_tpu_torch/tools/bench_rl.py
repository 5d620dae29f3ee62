"""RL north-star on the card (BASELINE.md measurement configs #1/#3).

The learners run on --device, the CUDA card unless --device cpu is
given (with no card and no --device the learner's build raises):

    python -m ray_tpu_torch.tools.bench_rl [--out FILE] [--seconds 180]
        [--only ppo|impala] [--device cuda|cpu]

- Config #1: PPO CartPole-v1 single-learner (num_env_runners=0). The
  driver-local EnvRunner keeps its module on the host CPU while the
  Learner's minibatch SGD runs on the learner's device; the SGD sweep
  reads its stats once, at its end (core/learner.py update).
- Config #3 shape: IMPALA MiniPong — CPU EnvRunner actors shipping
  time-major fragments through the object store to a learner thread on
  the card, fed by a DeviceFeed (rllib/utils/device_feed.py: pinned host
  stages, copies on a side stream) that records feed-stall %.

reference parity: the reference's headline RL numbers are
throughput-to-reward (rllib/tuned_examples/impala/pong-impala-fast.yaml:1-5,
ppo/pong-ppo.yaml); its microbench suite shape is ray_perf.py. Reported
metrics: platform, learner updates/sec, env-steps/sec, feed-stall %.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _timed(obj, name, bucket):
    """Wrap obj.<name> so cumulative wall time lands in bucket[name]."""
    inner = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        bucket[name] = bucket.get(name, 0.0) + time.perf_counter() - t0
        bucket[name + "_calls"] = bucket.get(name + "_calls", 0) + 1
        return out

    setattr(obj, name, wrapper)


def _ret_mean(last: dict):
    """NaN-safe episode_return_mean (NaN would break strict JSON)."""
    v = last.get("env_runners", {}).get("episode_return_mean")
    if v is None or v != v:
        return None
    return round(float(v), 2)


def _platform(device) -> str:
    """Where a learner on `device` runs: "cuda" or "cpu" (None is the
    card, raising where there is none)."""
    from ray_tpu_torch._device import resolve_device
    return resolve_device(device).type


def _devices(platform: str) -> list:
    """The cards' names, as torch.cuda.get_device_name gives them, or
    ["cpu"]."""
    import torch
    if platform != "cuda":
        return ["cpu"]
    return [torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())]


def _synchronize(learner) -> None:
    """Wait for the work queued on the learner's card (no-op on the
    CPU)."""
    import torch
    p = next(learner.module.parameters())
    if p.is_cuda:
        torch.cuda.synchronize(p.device)


def bench_ppo_cartpole(seconds: float, device=None) -> dict:
    """BASELINE config #1: PPO CartPole-v1, single in-process learner."""
    from ray_tpu_torch._private import goodput
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig

    # bind a goodput ledger on the driving thread so LearnerGroup.update
    # and the sentinel's compile charges classify this run's wall time
    goodput.ledger("bench_ppo").bind()

    cfg = (PPOConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                        rollout_fragment_length=128)
           .training(lr=1e-3, train_batch_size=1024, minibatch_size=256,
                     num_epochs=10, entropy_coeff=0.01,
                     vf_clip_param=10000.0, grad_clip=40.0)
           .learners(device=device)
           .debugging(seed=0))
    algo = cfg.build()
    times: dict = {}
    _timed(algo.learner_group, "update", times)
    _timed(algo.env_runners, "sample_sync", times)

    algo.train()  # warmup: the first update's allocations land here
    times.clear()
    base_steps = algo._timesteps_total

    t0 = time.perf_counter()
    iters = 0
    last = {}
    while time.perf_counter() - t0 < seconds:
        last = algo.train()
        iters += 1
    wall = time.perf_counter() - t0
    env_steps = algo._timesteps_total - base_steps
    # num_epochs x (train_batch/minibatch) minibatch updates per iteration
    updates = iters * cfg.num_epochs * (
        cfg.train_batch_size // cfg.minibatch_size)
    result = {
        "platform": algo.learner_group._local.device.type,
        "iterations": iters,
        "wall_s": round(wall, 2),
        "env_steps_total": int(env_steps),
        "env_steps_per_sec": round(env_steps / wall, 1),
        "learner_updates_per_sec": round(
            updates / times.get("update", wall), 1),
        "learn_phase_s": round(times.get("update", 0.0), 2),
        "sample_phase_s": round(times.get("sample_sync", 0.0), 2),
        "episode_return_mean": _ret_mean(last),
        "goodput": goodput.summary().get("bench_ppo"),
    }
    algo.stop()
    goodput.unbind()
    return result


def bench_impala_minipong(seconds: float, device=None) -> dict:
    """BASELINE config #3 shape: CPU EnvRunner actors -> a learner
    thread on the card with a double-buffered device feed."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch._private import goodput
    from ray_tpu_torch.rllib.algorithms.impala.impala import ImpalaConfig

    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    cfg = (ImpalaConfig()
           .environment("MiniPong-v0",
                        env_config={"paddle_w": 5, "max_returns": 3,
                                    "speeds": (-0.5, 0.5)})
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=32)
           .training(lr=6e-4, train_batch_size=256, entropy_coeff=0.02,
                     grad_clip=40.0)
           .learners(device=device)
           .debugging(seed=0))
    algo = cfg.build()
    # Warmup until the learner thread has run its first update.
    last = {}
    warm_t0 = time.perf_counter()
    while time.perf_counter() - warm_t0 < 120:
        last = algo.train()
        if last.get("num_updates_total", 0) >= 1:
            break
    base_sampled = algo._timesteps_total
    base_trained = last.get("num_env_steps_trained_total", 0)
    base_updates = last.get("num_updates_total", 0)
    feed0 = dict(last.get("device_feed", {}))

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        last = algo.train()
    wall = time.perf_counter() - t0
    feed = last.get("device_feed", {})
    sampled = algo._timesteps_total - base_sampled
    trained = last.get("num_env_steps_trained_total", 0) - base_trained
    updates = last.get("num_updates_total", 0) - base_updates
    wait_s = feed.get("feed_wait_s", 0.0) - feed0.get("feed_wait_s", 0.0)
    xfer_s = feed.get("feed_xfer_s", 0.0) - feed0.get("feed_xfer_s", 0.0)
    busy_s = (feed.get("learner_busy_s", 0.0)
              - feed0.get("learner_busy_s", 0.0))
    total = wait_s + busy_s
    learner = algo.learner_group._local
    result = {
        "platform": (learner.device.type if learner is not None
                     else _platform(device)),
        "wall_s": round(wall, 2),
        "env_steps_sampled": int(sampled),
        "env_steps_sampled_per_sec": round(sampled / wall, 1),
        "env_steps_trained": int(trained),
        "env_steps_trained_per_sec": round(trained / wall, 1),
        "learner_updates": int(updates),
        "learner_updates_per_sec": round(updates / wall, 2),
        "feed_stall_pct": round(100.0 * wait_s / total, 1) if total else None,
        "feed_xfer_stall_pct": (
            round(100.0 * xfer_s / total, 2) if total else None),
        "learner_busy_s": round(busy_s, 2),
        "episode_return_mean": _ret_mean(last),
        "num_healthy_env_runners": last.get("num_healthy_env_runners"),
        # the learner thread binds the "impala" ledger: its wall time
        # split into productive/compile/feed_stall/idle
        "goodput": goodput.summary().get("impala"),
    }
    algo.stop()

    # Card-side capability in isolation: device-resident V-trace updates
    # on the same module/batch shape, without the host sampling
    # bottleneck. The gap between this and env_steps_trained_per_sec is
    # the host's feed, not the card.
    import numpy as np
    if learner is not None:
        t_len, b = 32, 8
        obs_shape = algo.observation_space.shape
        batch = {
            "obs": (np.random.rand(t_len, b, *obs_shape) * 255).astype(
                np.uint8),
            "actions": np.random.randint(0, 3, (t_len, b)),
            "rewards": np.random.rand(t_len, b).astype(np.float32),
            "dones": np.zeros((t_len, b), bool),
            "behaviour_logp": np.full((t_len, b), -1.0, np.float32),
            "bootstrap_value": np.zeros((b,), np.float32),
        }
        dev = {k: torch.from_numpy(v).to(learner.device)
               for k, v in batch.items()}
        _synchronize(learner)
        learner.update(dev)  # warm
        n_up = 30
        t0 = time.perf_counter()
        for _ in range(n_up):
            learner.update(dev)
        _synchronize(learner)
        dt = time.perf_counter() - t0
        result["learner_only_updates_per_sec"] = round(n_up / dt, 1)
        result["learner_only_env_steps_per_sec"] = round(
            n_up * t_len * b / dt, 0)
    ray_tpu_torch.shutdown()
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write JSON results to this path")
    ap.add_argument("--seconds", type=float, default=180.0,
                    help="wall budget per config")
    ap.add_argument("--only", choices=["ppo", "impala"], default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the learners' device (default: the card, "
                         "raising where there is none)")
    args = ap.parse_args(argv)

    platform = _platform(args.device)
    results = {
        "suite": "rl_north_star_on_chip",
        "round": 5,
        "platform": platform,
        "devices": _devices(platform),
        "results": {},
    }
    if args.only in (None, "ppo"):
        results["results"]["ppo_cartpole_single_learner"] = \
            bench_ppo_cartpole(args.seconds, args.device)
    if args.only in (None, "impala"):
        results["results"]["impala_minipong_gpu_learner"] = \
            bench_impala_minipong(args.seconds, args.device)
    line = json.dumps(results)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
