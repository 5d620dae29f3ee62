"""Sustained many-writer/many-reader replay throughput (ROADMAP item 5).

    python -m ray_tpu_torch.tools.bench_replay [--seconds 8] [--shards 1,2,4]
        [--writers 2] [--format=json]

Two modes over identical synthetic transition streams:

- `driver_buffer` (the pre-replay-plane path, dqn.py sync
  training_step): writer actors produce fragments, the driver fetches
  each one with a blocking `ray_tpu_torch.get`, adds it to ONE in-driver
  (Prioritized)ReplayBuffer, then samples + applies priority updates
  locally — store, sample, and update all serialized on the driver
  thread, one round trip per fragment.
- `replay_shards` (rllib/utils/replay/): the same writer actors push
  straight to N ReplayShardActors through ReplayWriter (scatter-put
  refs, bounded inflight), while the driver's ReplayGroup keeps sample
  RPCs pipelined against every shard and routes priority updates back
  one-way. Nothing serializes on the driver: pushes, pulls, and
  updates overlap.

Reported per shard count: adds/s, samples/s, priority-updates/s, and
per-op RPC counts. The acceptance bar is sharded add+sample throughput
>= 2x the driver-buffer path on the same box — on a single-core host
the win comes from overlap: writer rollout time (env_step_ms per
fragment) and sample RPCs pipeline against each other instead of
serializing on the driver thread.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

ROWS_PER_PUSH = 64
TRAIN_BATCH = 64
OBS_DIM = 16
CAPACITY = 20_000


def _make_batch(rng: np.random.Generator) -> dict:
    return {
        "obs": rng.standard_normal(
            (ROWS_PER_PUSH, OBS_DIM)).astype(np.float32),
        "actions": rng.integers(0, 4, ROWS_PER_PUSH).astype(np.int64),
        "rewards": rng.standard_normal(ROWS_PER_PUSH).astype(np.float32),
        "dones": np.zeros(ROWS_PER_PUSH, np.float32),
        "discounts": np.full(ROWS_PER_PUSH, 0.99, np.float32),
        "next_obs": rng.standard_normal(
            (ROWS_PER_PUSH, OBS_DIM)).astype(np.float32),
    }


class _Writer:
    """One env-runner stand-in: produces fragments (driver-buffer mode)
    or pushes them straight to the shard fleet (replay-shards mode).
    `env_step_ms` models the rollout cost of producing one fragment —
    without it the synthetic stream is microseconds per fragment and no
    real env runner is that cheap."""

    def __init__(self, seed: int, env_step_ms: float = 20.0):
        self._rng = np.random.default_rng(seed)
        self._env_step_s = env_step_ms / 1000.0

    def ready(self) -> bool:
        """Answers once the actor is up, with push_until's imports done
        (the replay package imports torch: seconds in a fresh worker)."""
        from ray_tpu_torch.rllib.utils.replay import ReplayWriter  # noqa: F401
        return True

    def make_fragment(self) -> dict:
        if self._env_step_s:
            time.sleep(self._env_step_s)
        return _make_batch(self._rng)

    def push_until(self, spec: dict, deadline_mono: float) -> dict:
        from ray_tpu_torch.rllib.utils.replay import ReplayWriter
        writer = ReplayWriter(
            spec["shards"],
            max_inflight_per_shard=spec["max_inflight_per_shard"])
        seq = 0
        while time.monotonic() < deadline_mono:
            writer.push(self.make_fragment(), route_key=str(seq))
            seq += 1
        writer.flush()
        return writer.stats()


def bench_driver_buffer(seconds: float, num_writers: int,
                        env_step_ms: float) -> dict:
    import ray_tpu_torch
    from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer

    cls = ray_tpu_torch.remote(_Writer)
    writers = [cls.remote(seed=100 + i, env_step_ms=env_step_ms)
               for i in range(num_writers)]
    # the clock starts once the actors are up: an actor's start can
    # outlast a short stage, which then counts no fragment
    ray_tpu_torch.get([w.ready.remote() for w in writers], timeout=120)
    buf = PrioritizedReplayBuffer(CAPACITY, seed=0)
    fetches = samples = updates = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        # serial round trip per fragment — the dqn.py:336 sync shape
        batch = ray_tpu_torch.get(  # graftlint: disable=RT002
            writers[i % num_writers].make_fragment.remote())
        i += 1
        buf.add(batch)
        fetches += 1
        if len(buf) >= TRAIN_BATCH:
            out = buf.sample(TRAIN_BATCH, beta=0.4)
            samples += 1
            buf.update_priorities(
                out["batch_indexes"],
                np.abs(out["rewards"]) + 0.1,
                epochs=out["item_epochs"])
            updates += 1
    wall = time.perf_counter() - t0
    return {
        "mode": "driver_buffer",
        "wall_s": round(wall, 2),
        "adds_per_sec": round(buf.num_added / wall, 1),
        "samples_per_sec": round(samples * TRAIN_BATCH / wall, 1),
        "priority_updates_per_sec": round(
            updates * TRAIN_BATCH / wall, 1),
        "add_plus_sample_per_sec": round(
            (buf.num_added + samples * TRAIN_BATCH) / wall, 1),
        "rpc_counts": {"fragment_gets": fetches},
    }


def bench_replay_shards(seconds: float, num_writers: int,
                        num_shards: int,
                        env_step_ms: float) -> dict:
    import ray_tpu_torch
    from ray_tpu_torch.rllib.utils.replay import ReplayGroup

    group = ReplayGroup(
        num_shards, max(1, CAPACITY // num_shards),
        prioritized=True, batch_size=TRAIN_BATCH,
        min_size_to_sample=TRAIN_BATCH, seed=0,
        name=f"bench{num_shards}", queue_depth=4,
        sample_inflight_per_shard=2)
    group.start()
    spec = {"shards": group.shard_handles(),
            "max_inflight_per_shard": 4}
    cls = ray_tpu_torch.remote(_Writer)
    writers = [cls.remote(seed=100 + i, env_step_ms=env_step_ms)
               for i in range(num_writers)]
    # the clock starts once the writers and the shards are up
    ray_tpu_torch.get([w.ready.remote() for w in writers], timeout=120)
    group.shard_stats()
    t0 = time.perf_counter()
    deadline_mono = time.monotonic() + seconds
    push_refs = [w.push_until.remote(spec, deadline_mono)
                 for w in writers]
    pulled = updates = 0
    while time.monotonic() < deadline_mono:
        item = group.get_batch(timeout=0.2)
        if item is None:
            continue
        staged, meta = item
        d = staged.as_dict()
        group.update_priorities(
            meta["shard_id"], d["batch_indexes"],
            np.abs(d["rewards"]) + 0.1, d["item_epochs"])
        updates += 1
        staged.release()
        pulled += 1
    writer_stats = ray_tpu_torch.get(push_refs, timeout=60)
    wall = time.perf_counter() - t0
    shard_stats = group.shard_stats()
    group.stop()
    added = sum(s["added"] for s in shard_stats)
    sampled = sum(s["sampled"] for s in shard_stats)
    return {
        "mode": "replay_shards",
        "num_shards": num_shards,
        "wall_s": round(wall, 2),
        "adds_per_sec": round(added / wall, 1),
        "samples_per_sec": round(pulled * TRAIN_BATCH / wall, 1),
        "priority_updates_per_sec": round(
            updates * TRAIN_BATCH / wall, 1),
        "add_plus_sample_per_sec": round(
            (added + pulled * TRAIN_BATCH) / wall, 1),
        "sampled_at_shards_per_sec": round(sampled / wall, 1),
        "rpc_counts": {
            "pushes": sum(w["pushes"] for w in writer_stats),
            "pushes_shed": sum(w["shed"] for w in writer_stats),
            "sample_rpcs": sum(s["sample_rpcs"] for s in shard_stats),
            "update_rpcs": sum(s["update_rpcs"] for s in shard_stats),
        },
        "unmatched_priority_updates": sum(
            s["unmatched_priority_updates"] for s in shard_stats),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--writers", type=int, default=4)
    ap.add_argument("--env-step-ms", type=float, default=20.0,
                    help="simulated rollout cost per fragment")
    ap.add_argument("--shards", default="1,2,4")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=max(4, args.writers + 4))

    results = {"driver_buffer": bench_driver_buffer(
        args.seconds, args.writers, args.env_step_ms)}
    for n in [int(s) for s in args.shards.split(",") if s]:
        results[f"replay_shards_{n}"] = bench_replay_shards(
            args.seconds, args.writers, n, args.env_step_ms)
    base = results["driver_buffer"]["add_plus_sample_per_sec"]
    for k, r in results.items():
        if k != "driver_buffer" and base:
            r["speedup_vs_driver_buffer"] = round(
                r["add_plus_sample_per_sec"] / base, 2)
    out = {
        "suite": "replay_throughput",
        "writers": args.writers,
        "env_step_ms": args.env_step_ms,
        "rows_per_push": ROWS_PER_PUSH,
        "train_batch": TRAIN_BATCH,
        "results": results,
    }
    ray_tpu_torch.shutdown()
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.format == "json":
        print(text)
    else:
        for k, r in results.items():
            print(f"{k}: add+sample {r['add_plus_sample_per_sec']}/s "
                  f"(adds {r['adds_per_sec']}/s, samples "
                  f"{r['samples_per_sec']}/s, updates "
                  f"{r['priority_updates_per_sec']}/s)"
                  + (f"  x{r['speedup_vs_driver_buffer']}"
                     if "speedup_vs_driver_buffer" in r else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
