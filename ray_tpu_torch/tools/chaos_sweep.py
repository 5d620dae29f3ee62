"""Chaos seed sweep: run a workload under N seeded fault schedules.

Systematic interleaving/fault-schedule exploration (the chaos-plane
successor of the RAY_TPU_testing_rpc_delay_seed sweep in
tests/test_fault_tolerance.py): each seed parameterizes every
probabilistic rule in the chosen schedule, so one sweep explores N
different — but individually replayable — fault patterns over the same
workload. A failing seed is a repro: re-run with --seeds <seed>.

Schedules are named presets over the built-in smoke workload (tasks +
actor calls + a large put/get), or bring your own workload script with
--script (it runs under an already-initialized driver with the schedule
installed; exit 0 = pass).

The port's copy of tools/chaos_sweep.py: the schedules and the sweep are
the JAX package's; the workloads of "elastic", "wedge" and "replay" run
on the port (a TorchTrainer loop in torch, the port's DQN) on the card,
or on the CPU with --device cpu.

Usage (from the repo root):
    python -m ray_tpu_torch.tools.chaos_sweep --schedule rpc-delay \
        --seeds 1,7,42
    python -m ray_tpu_torch.tools.chaos_sweep --schedule drops \
        --num-seeds 5 --format=json
    python -m ray_tpu_torch.tools.chaos_sweep --schedule elastic \
        --device cpu --seeds 3
    python -m ray_tpu_torch.tools.chaos_sweep --schedule store-errors \
        --script my_workload.py
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Each schedule: list of rule dicts (ray_tpu_torch.chaos.inject kwargs); the
# sweep rewrites `seed` per run. Probabilities stay low enough that the
# retry/recovery machinery is exercised without starving the workload.
SCHEDULES = {
    "rpc-delay": [
        {"fault": "delay", "method": "*", "delay_ms": 3.0,
         "jitter": True, "probability": 1.0},
    ],
    "drops": [
        {"fault": "drop_connection", "method": "kv_*",
         "probability": 0.05},
        {"fault": "drop_connection", "method": "get_*",
         "probability": 0.05},
        {"fault": "delay", "method": "w_push_task", "delay_ms": 2.0,
         "jitter": True, "probability": 0.5},
    ],
    "store-errors": [
        {"fault": "error", "method": "store_create",
         "probability": 0.05,
         "error_message": "chaos sweep: injected store error"},
        {"fault": "delay", "method": "store_*", "delay_ms": 2.0,
         "jitter": True, "probability": 0.5},
    ],
    # elastic kill -> shrink -> rejoin -> grow drill: seeded kills of
    # train-gang members while the elastic workload below runs; every
    # fire forces a full reconfiguration cycle (drain / checkpoint /
    # re-form at the feasible world size / reshard / resume), and a
    # kill landing mid-re-form exercises shrink-below-target with the
    # replacement probe growing the gang back. Use
    # --cycles/RAY_TPU_SWEEP_ELASTIC_CYCLES for the heavy multi-cycle
    # variant (tests keep it behind -m slow; tier-1 runs 1 cycle).
    "elastic": [
        {"fault": "kill_worker", "actor_class": "RayTrainWorker",
         "method": "w_*", "probability": 0.02, "max_fires": 2},
    ],
    # collective-wedge drill: seeded SIGSTOPs of train-gang members
    # (fires on node-manager dispatch — the NM is the actuator) while
    # the wedge workload below runs with a tight step deadline. The 8s
    # stall outlives detection (~5s with the workload's tightened
    # knobs) by design: the supervisor must hard-kill the stopped rank
    # (SIGKILL works on stopped processes) and re-form, and the
    # actuator's eventual SIGCONT usually lands on a dead pid — the
    # tolerated "stray resume". A stall landing outside a result round
    # (e.g. during formation, whose waits are not wedge-aware) resolves
    # itself at SIGCONT, bounding the hang. Fires during rounds must
    # show up as reason="wedge" reconfigurations; ownership must drain.
    "wedge": [
        {"fault": "stall_worker", "actor_class": "RayTrainWorker",
         "method": "nm_*", "probability": 0.1, "max_fires": 2,
         "delay_ms": 8000.0},
    ],
    # replay-plane drill: kill one ReplayShardActor mid-training (the
    # after_n counter makes the death land deterministically once the
    # shard has served a few push/sample RPCs, whatever the seed does
    # to the timing), plus seeded delay and bounded connection drops on
    # the task-push RPC path that carries replay push/sample/update
    # traffic. The workload below must keep training through it: the
    # ReplayGroup replaces the dead shard (fresh generation, empty
    # buffer), env runners get a re-spec'd writer, and ownership drains.
    "replay": [
        {"fault": "kill_worker", "actor_class": "ReplayShardActor",
         "method": "w_push_task", "after_n": 10, "probability": 1.0,
         "max_fires": 1},
        {"fault": "delay", "method": "w_push_task", "delay_ms": 2.0,
         "jitter": True, "probability": 0.3},
        {"fault": "drop_connection", "method": "w_push_task",
         "probability": 0.02, "max_fires": 4},
    ],
}

_SMOKE_WORKLOAD = """
import ray_tpu_torch

@ray_tpu_torch.remote(max_retries=3)
def f(x):
    return x + 1

assert ray_tpu_torch.get([f.remote(i) for i in range(20)],
                   timeout=120) == list(range(1, 21))

@ray_tpu_torch.remote
class A:
    def g(self, x):
        return x * 2

a = A.options(num_cpus=0.1).remote()
assert ray_tpu_torch.get([a.g.remote(i) for i in range(10)],
                   timeout=120) == [i * 2 for i in range(10)]

import numpy as np
arr = np.arange(1 << 18, dtype=np.int32)
for _ in range(3):
    try:
        ref = ray_tpu_torch.put(arr)
        break
    except Exception:
        continue  # injected store error: retry the put
else:
    raise RuntimeError("put never survived the store-error schedule")
assert ray_tpu_torch.get(ref, timeout=120).sum() == arr.sum()
print("SWEEP_WORKLOAD_OK")
"""

# The elastic and wedge workloads' train loop (the JAX package's runs
# no math; this one trains in torch, as a TorchTrainer user's does): a
# linear regression whose rows each rank takes by world size (rank::world,
# the reshard), Adam, rank 0 checkpointing params, Adam's state and the
# step with torch.save into a pid-suffixed staging directory (a drained
# zombie rank 0 must not tear the new gang's files), a resumed gang
# loading them on every rank; `pause_s` is a per-step compute window in
# which a stall can land. The sweep's --device picks the card (two
# workers share it through GPU 0.5 each and a gloo group: NCCL takes no
# two ranks on one card) or the CPU.
_TORCH_LOOP = """
import os
import tempfile
import time

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                 ScalingConfig, TorchConfig, TorchTrainer)

device = os.environ.get("RAY_TPU_SWEEP_DEVICE", "cuda")
cycles = int(os.environ.get("RAY_TPU_SWEEP_ELASTIC_CYCLES", "1"))
steps_total = 6 * cycles


def loop(config):
    import torch

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    torch.set_num_threads(1)
    dev = torch.device(config["device"])
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(24, 4, generator=gen)
    y = x @ torch.tensor([1.0, -2.0, 3.0, 0.5])
    w = torch.zeros(4, device=dev, requires_grad=True)
    opt = torch.optim.Adam([w], lr=0.05)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt:
        state = torch.load(os.path.join(ckpt.path, "state.pt"),
                           map_location=dev)
        with torch.no_grad():
            w.copy_(state["w"])
        opt.load_state_dict(state["opt"])
        start = state["step"] + 1
        # Adam resumes where the checkpoint left it
        assert int(opt.state_dict()["state"][0]["step"]) == start
    for step in range(start, config["steps"]):
        time.sleep(config["pause_s"])
        xs, ys = x[rank::world].to(dev), y[rank::world].to(dev)
        loss = ((xs @ w - ys) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        metrics = {"step": step, "world": world, "loss": loss.item()}
        if rank == 0:
            cdir = os.path.join(config["base"],
                                f"wip_{step}_{os.getpid()}")
            os.makedirs(cdir, exist_ok=True)
            torch.save({"w": w.detach().cpu(), "opt": opt.state_dict(),
                        "step": step}, os.path.join(cdir, "state.pt"))
            c = Checkpoint(cdir)
            c.update_metadata({"step": step})
            train.report(metrics, checkpoint=c)
        else:
            train.report(metrics)


def fit(name, pause_s, **scaling):
    base = tempfile.mkdtemp(prefix=name + "_")
    on_card = device == "cuda"
    return TorchTrainer(
        loop, train_loop_config={"steps": steps_total, "base": base,
                                 "device": device, "pause_s": pause_s},
        torch_config=TorchConfig(backend="gloo"),
        scaling_config=ScalingConfig(
            num_workers=2, use_gpu=on_card,
            resources_per_worker={"CPU": 1, "GPU": 0.5} if on_card
            else {"CPU": 1},
            elastic_min_workers=1, elastic_reform_timeout_s=10.0,
            **scaling),
        run_config=RunConfig(
            storage_path=base, name=name,
            failure_config=FailureConfig(max_failures=10))).fit()


def assert_ownership_drains(what):
    # ownership drain canary: gang teardown and re-form must not leak
    # lease slots or pins
    import gc

    from ray_tpu_torch._private import ownership
    from ray_tpu_torch._private import worker as worker_mod

    cw = worker_mod.global_worker().core_worker
    deadline = time.monotonic() + 15
    leaks = []
    while time.monotonic() < deadline:
        gc.collect()
        with cw._lock:
            leaks = ownership.lease_drain_report(cw._ltab)
        if not leaks:
            break
        time.sleep(0.25)
    assert not leaks, f"ownership leak after {what}: " + "; ".join(leaks)
"""

# Elastic drill workload (schedule "elastic"): the loop above on a
# 2-worker elastic TorchTrainer run to completion under seeded
# gang-member kills. Cycle count via RAY_TPU_SWEEP_ELASTIC_CYCLES (6
# checkpointed steps per cycle); exit 0 requires the run to finish at
# the full step count AND the driver's ownership plane to drain
# afterwards (no leaked pins/leases from torn-down gang generations).
_ELASTIC_WORKLOAD = _TORCH_LOOP + """
result = fit("elastic_sweep", 0.0)
assert result.error is None, f"elastic run failed: {result.error!r}"
assert result.metrics["step"] == steps_total - 1, result.metrics
assert_ownership_drains("elastic cycles")
print("ELASTIC_WORKLOAD_OK")
"""

# Wedge drill workload (schedule "wedge"): the elastic drill with the
# collective-wedge supervisor armed tight — explicit 2s step deadline,
# 3s heartbeat staleness — so a SIGSTOPped rank (which freezes the
# heartbeat sidecar too) trips detect -> hard-kill -> re-form within a
# few seconds instead of the defaults' ~12s, and a 0.2 s compute window
# a step in which the stall can land. Exit 0 requires the run to finish
# at the full step count and the ownership plane to drain; the stall
# fires and wedge reconfigurations are printed for the record.
_WEDGE_WORKLOAD = _TORCH_LOOP + """
from ray_tpu_torch import chaos
from ray_tpu_torch._private.config import Config
from ray_tpu_torch.util import metrics as metrics_mod

# tighten detection: trip needs BOTH the step deadline expired AND a
# heartbeat stale past this threshold (two-factor; driver-side check)
Config.watchdog_gang_heartbeat_s = 3.0

result = fit("wedge_sweep", 0.2, step_deadline_s=2.0)
assert result.error is None, f"wedge run failed: {result.error!r}"
assert result.metrics["step"] == steps_total - 1, result.metrics

# A fire landing inside a result round trips a reason="wedge" re-form; a
# fire landing outside a round (formation, teardown) self-resolves at
# SIGCONT without a trip. The hard invariants are completion at the full
# step count and a clean ownership drain.
fired = sum(r["fired"] for r in chaos.list_rules())
counter = metrics_mod.get_or_create(
    metrics_mod.Counter, "ray_tpu_elastic_reconfigurations_total",
    tag_keys=("reason",))
reasons = {dict(k).get("reason"): v
           for k, v in counter.snapshot()["values"].items()}
assert_ownership_drains("wedge cycles")
print(f"WEDGE_WORKLOAD_OK fired={fired} wedges={reasons.get('wedge', 0)}")
"""

# Replay drill workload (schedule "replay"): a small sharded-replay
# DQN of the port (1 env runner, 2 prioritized shards, the learner on
# the sweep's --device) trained through the seeded shard kill + RPC
# delay/drop schedule above. Exit 0 requires training to keep making
# progress (steps trained keep growing after the kill), the dead shard
# to be replaced by a fresh generation, and the driver's ownership
# plane to drain afterwards.
_REPLAY_WORKLOAD = """
import os
import time

from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig

algo = (DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, rollout_fragment_length=32)
        .training(buffer_size=2000, train_batch_size=16,
                  num_steps_sampled_before_learning_starts=32,
                  target_network_update_freq=200, prioritized_replay=True,
                  num_replay_shards=2, replay_shard_capacity=500)
        .learners(device=os.environ.get("RAY_TPU_SWEEP_DEVICE", "cuda"))
        .debugging(seed=0)
        .build())

# The port's iterations take milliseconds where the JAX package's take
# far longer, so the workload trains for wall time (JAX: 25 iterations):
# until the dead shard has been replaced and the learner has trained, or
# REPLAY_S seconds. The sweep's --timeout bounds the seed as a whole.
REPLAY_S = 120
deadline = time.monotonic() + REPLAY_S
result = {}
replaced_at = None
i = 0
while time.monotonic() < deadline:
    result = algo.train()
    if replaced_at is None and \
            result.get("replay", {}).get("shard_replacements", 0) >= 1:
        replaced_at = i
    i += 1
    if replaced_at is not None and \
            result["num_env_steps_trained_total"] > 0:
        break
rep = result.get("replay", {})
assert rep.get("shard_replacements", 0) >= 1, (
    "chaos kill never cost a shard: " + repr(rep))
assert rep.get("healthy_shards") == 2, rep
assert result["num_env_steps_trained_total"] > 0, result
# progress after the replacement: run a few more iterations and require
# the trained counter to keep moving on the re-formed shard fleet
before = result["num_env_steps_trained_total"]
deadline = time.monotonic() + 60
after = before
while time.monotonic() < deadline:
    result = algo.train()
    after = result["num_env_steps_trained_total"]
    if after > before:
        break
assert after > before, (before, after)
algo.stop()

# ownership drain canary: the dead shard generation, its inflight push
# refs, and the pipelined sample refs must not leak pins or leases
import gc

from ray_tpu_torch._private import ownership
from ray_tpu_torch._private import worker as worker_mod

cw = worker_mod.global_worker().core_worker
deadline = time.monotonic() + 15
leaks = []
while time.monotonic() < deadline:
    gc.collect()
    with cw._lock:
        leaks = ownership.lease_drain_report(cw._ltab)
    if not leaks:
        break
    time.sleep(0.25)
assert not leaks, "ownership leak after replay chaos: " + "; ".join(leaks)
print(f"REPLAY_WORKLOAD_OK replaced_at_iter={replaced_at}")
"""

_RUNNER = """
import json
import sys

import ray_tpu_torch
from ray_tpu_torch import chaos

spec = json.loads(sys.argv[1])
ray_tpu_torch.init(num_cpus=2)
rules = []
for rule in spec["rules"]:
    rule = dict(rule)
    rule.setdefault("seed", spec["seed"])
    rule["seed"] = rule["seed"] or spec["seed"]
    rules.append(rule)
chaos.inject_many(rules)
exec(compile(open(sys.argv[2]).read(), sys.argv[2], "exec"))
fired = sum(r["fired"] for r in chaos.list_rules())
print(f"SWEEP_FIRED={fired}")
ray_tpu_torch.shutdown()
"""


def run_seed(schedule, seed, script_path, timeout):
    spec = json.dumps({"rules": SCHEDULES[schedule], "seed": seed})
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-u", "-c", _RUNNER, spec, script_path],
            capture_output=True, text=True, timeout=timeout,
            cwd=REPO)
    except subprocess.TimeoutExpired as e:
        # a hung seed is the sweep's most valuable find — record it as
        # a failing seed instead of crashing the sweep
        def _txt(b):
            return b.decode(errors="replace") if isinstance(b, bytes) \
                else (b or "")
        return {
            "seed": seed, "ok": False, "fired": 0, "timed_out": True,
            "duration_s": round(time.time() - t0, 2),
            "tail": ("TIMEOUT after %.0fs\n" % timeout)
            + _txt(e.stdout)[-1500:] + _txt(e.stderr)[-1500:],
        }
    fired = 0
    for line in proc.stdout.splitlines():
        if line.startswith("SWEEP_FIRED="):
            fired = int(line.split("=", 1)[1])
    return {
        "seed": seed,
        "ok": proc.returncode == 0,
        "fired": fired,
        "duration_s": round(time.time() - t0, 2),
        "tail": "" if proc.returncode == 0
        else (proc.stdout[-1500:] + proc.stderr[-1500:]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(
        description="sweep chaos seeds over a fault schedule")
    ap.add_argument("--schedule", choices=sorted(SCHEDULES),
                    default="rpc-delay")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated explicit seeds")
    ap.add_argument("--num-seeds", type=int, default=3,
                    help="seeds 1..N when --seeds is not given")
    ap.add_argument("--script", default=None,
                    help="workload python file (default: built-in smoke;"
                         " schedule 'elastic' runs the elastic drill)")
    ap.add_argument("--cycles", type=int, default=1,
                    help="elastic schedule: training cycles per seed "
                         "(6 checkpointed steps each; multi-cycle is "
                         "the heavy drill)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="per-seed wall clock budget (s)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the elastic, wedge and replay workloads "
                         "compute (default: the card)")
    args = ap.parse_args()

    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds \
        else list(range(1, args.num_seeds + 1))
    if args.schedule in ("elastic", "wedge"):
        os.environ["RAY_TPU_SWEEP_ELASTIC_CYCLES"] = str(args.cycles)
    os.environ["RAY_TPU_SWEEP_DEVICE"] = args.device
    script_path = args.script
    tmp = None
    if script_path is None:
        import tempfile
        fd, tmp = tempfile.mkstemp(suffix="_chaos_smoke.py")
        with os.fdopen(fd, "w") as f:
            f.write({"elastic": _ELASTIC_WORKLOAD,
                     "wedge": _WEDGE_WORKLOAD,
                     "replay": _REPLAY_WORKLOAD}.get(args.schedule,
                                                     _SMOKE_WORKLOAD))
        script_path = tmp

    results = []
    try:
        for seed in seeds:
            rec = run_seed(args.schedule, seed, script_path, args.timeout)
            results.append(rec)
            if args.format == "text":
                status = "PASS" if rec["ok"] else "FAIL"
                print(f"seed {seed:>4}: {status}  fired={rec['fired']}"
                      f"  {rec['duration_s']}s", flush=True)
                if not rec["ok"]:
                    print(rec["tail"])
    finally:
        if tmp is not None:
            os.unlink(tmp)

    failed = [r["seed"] for r in results if not r["ok"]]
    if args.format == "json":
        print(json.dumps({"schedule": args.schedule, "results": results,
                          "failed_seeds": failed}))
    elif failed:
        print(f"FAILED seeds: {failed} — replay with "
              f"--schedule {args.schedule} --seeds "
              f"{','.join(map(str, failed))}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
