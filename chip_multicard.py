#!/usr/bin/env python3
"""Four-card runs of the port (ray_tpu_torch): the north star's
multi-card configurations at full width and depth, on four H100s of one
host over NCCL.

    python3 chip_multicard.py [--out multicard.json]
                              [--only llama32,llama_tp,...]

Raises unless four CUDA cards are visible; exits non-zero if any check
fails (every phase runs, a failed one printing its traceback). Phases:

- "llama32": LLAMA2_7B (attention_impl "auto", the flash kernels) at all
  32 layers and full width through TorchTrainer.fit() with four NCCL
  workers on data=1 x fsdp=4, one 4,097-token row a card, LLAMA_WARMUP
  and LLAMA_TIMED steps: tokens/s a card, step ms, peak GiB a card (reset
  after the state is built), build s, flash launches a step (remat
  "full": 2 forward, 1 dK/dV, 1 dQ a layer). The first loss is ln(32000)
  + 1/2 +/- 0.5 (the untied head's unit-variance logits add the 1/2, as
  chip_smoke.py's phase "llama" holds it) and the loss falls. The model
  is built whole on each rank's own card (27 GB of f32, the init drawing
  in place), then init_state keeps each rank's quarter. Then one
  profiled step: device time by kernel, NCCL's all-gather, reduce-scatter
  and all-reduce broken out, the busy share and the longest idle gaps.
- "llama_tp": the same model, seed and batch on fsdp=2 x tensor=2, the
  embedding, head and cross-entropy vocab-parallel over `tensor`: its
  first loss within 2e-2 of "llama32"'s, peak GiB a card beside it.
- "llama_dp": data=2 x fsdp=2, each param 2-way sharded, at
  LLAMA_DP_LAYERS layers (the reckoning beside that constant).
- "narrow": a narrow Llama-shaped bf16 model on fsdp=2 x tensor=2 over
  NCCL against the CPU f32 path from the same params and tokens: loss
  2e-2, each grad's relative norm error 5e-2 (chip_smoke.py's bars); the
  vocab-parallel cross-entropy on NCCL.
- "impala4": IMPALA on MiniPong at chip_smoke.py's phase "impala"
  settings (fragment 50, batch 500, 6 runner actors) with four NCCL
  learners, one a card, against the same run with one (local) learner:
  env steps trained/s, the learner thread's perf_report buckets, and the
  four ranks' weights equal to the bit after the last update. Then IMPALA
  CartPole with four learners to reward >= 150, the bar of the JAX
  package's test_impala_cartpole_mesh_learners.

Each number is printed with the card's name and power limit
(nvidia-smi); --out writes every phase's record as JSON, and the
profiled step's table goes beside it (multicard_llama32_profile.txt).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback

SEED = 0
CARDS = 4
LLAMA_WARMUP, LLAMA_TIMED = 3, 5
# llama_tp and llama_dp: enough steps for a step time and a falling loss
SHORT_WARMUP, SHORT_TIMED = 1, 3
FIRST_LOSS_TOL = 2e-2          # llama_tp's first loss against llama32's
# "llama_dp" at data=2 x fsdp=2: each card holds half of every param, its
# grad and both Adam moments, 16 bytes a param / 2. LLAMA2_7B's 32 layers
# hold 6.476e9 params and its embed and head 0.262e9: 54.0 GB of state a
# card, plus the backward's per-layer grad shards before they are stacked
# (4 bytes a layer param / 2: 13.0 GB) and the activations and gathered
# layers (~3 GB at one row a card): ~70 GB (65 GiB) of the card's 79.1
# GiB. The init holds the whole f32 tree (27.0 GB) and the halves (13.5
# GB) at once. So all 32 layers fit.
LLAMA_DP_LAYERS = 32
NARROW_ROWS = 4
LOSS_TOL, GRAD_TOL = 2e-2, 5e-2
# phase "impala": chip_smoke.py's MiniPong settings, R runner actors
IMPALA_T, IMPALA_ENVS, IMPALA_RUNNERS = 50, 5, 6
IMPALA_S = 20.0                # wall seconds of algo.train() a run
# the JAX package's test_impala_cartpole_mesh_learners (tests/
# test_rl_round3.py:177-200) with 4 learners: its config and bar (its
# deadline 900 s; this run stops at 300 s)
CARTPOLE_BAR, CARTPOLE_DEADLINE_S = 150.0, 300.0
PHASES = ("llama32", "llama_tp", "llama_dp", "narrow", "impala4")


def llama_config(layers):
    from ray_tpu_torch.models import LLAMA2_7B
    return LLAMA2_7B.replace(n_layers=layers, attention_impl="auto")


def narrow_config():
    """Llama-shaped, narrow: head_dim 128 and bf16 (the flash kernels'),
    remat "full" and the chunked head, a vocab the tensor axis splits."""
    from ray_tpu_torch.models import LLAMA2_7B
    return LLAMA2_7B.replace(n_layers=2, d_model=1024, n_heads=8,
                             n_kv_heads=None, d_ff=2752, vocab_size=8192,
                             max_seq_len=1024, attention_impl="auto",
                             loss_chunk=256)


def layer_params(cfg):
    """(params of the layer stack, params of embed, head and final norm)."""
    d, f, h = cfg.d_model, cfg.ff_dim, cfg.n_heads * cfg.head_dim
    kv = cfg.kv_heads * cfg.head_dim
    per = d * (h + 2 * kv) + h * d + 3 * d * f + 2 * d
    top = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + d
    return cfg.n_layers * per, top


def tokens_batch(cfg, rows):
    import numpy as np
    return {"tokens": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (rows, cfg.max_seq_len + 1)).astype(np.int64)}


def profile_summary(gpu_profiler, run, out_path, rows=25):
    """summary() of one capture: device ms by kernel, NCCL's collectives
    by kind, the busy share and the longest idle gaps; the table goes to
    out_path."""
    s = gpu_profiler.summary(run)
    total = sum(r["us"] for r in s["kernels"].values())
    nccl = {}
    for name, r in s["kernels"].items():
        if name.lower().startswith("nccl"):
            kind = next((k for k in ("AllGather", "ReduceScatter",
                                     "AllReduce", "SendRecv", "Broadcast")
                         if k.lower() in name.lower()), "other")
            row = nccl.setdefault(kind, {"count": 0, "ms": 0.0})
            row["count"] += r["count"]
            row["ms"] += r["us"] / 1e3
    top = sorted(s["kernels"].items(), key=lambda kv: -kv[1]["us"])[:rows]
    with open(out_path, "w") as f:
        f.write(gpu_profiler.summary_table(run, rows=60) + "\n")
    return {"device_ms": total / 1e3, "busy_ms": s["busy_us"] / 1e3,
            "window_ms": s["window_us"] / 1e3,
            "busy_share": s["busy_us"] / s["window_us"]
            if s["window_us"] else 0.0,
            "idle_gaps_ms": [g / 1e3 for g in s["idle_gaps_us"]],
            "nccl": nccl,
            "top": [{"name": n[:120], "count": r["count"],
                     "ms": r["us"] / 1e3} for n, r in top]}


def llama_loop(config):
    """In each worker: the sharded step through make_train_step on
    config["mesh"]; rank 0 reports."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import train
    from ray_tpu_torch.models import Transformer
    from ray_tpu_torch.models import transformer as tmod
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step
    from ray_tpu_torch.util import gpu_profiler

    device = config["device"]
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size()
    cfg = config["cfg"]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = Transformer(cfg, device, seed=SEED)
    mesh = make_mesh(MeshConfig(**config["mesh"]), device=device)
    init_state, train_step = make_train_step(
        lambda p, b: model.loss(b, mesh=mesh), Transformer.param_specs(cfg),
        mesh, optimizer=adamw(1e-4, weight_decay=0.1), device=device)
    state = init_state(model)
    for name, p in state["params"].items():
        if not (isinstance(p, DTensor) and p.device_mesh == mesh
                and p.to_local().device.type == device):
            raise AssertionError(f"param {name} is not a {device} DTensor "
                                 f"on the mesh")
    sync()
    build_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    batch = tokens_batch(cfg, config["rows"])
    fa.reset_launches()
    # the widths of every head the first step's loss multiplies by
    widths, dot = [], tmod._dot_f32

    def recording(x, w):
        widths.append(tuple(w.shape))
        return dot(x, w)

    tmod._dot_f32 = recording
    try:
        state, metrics = train_step(state, batch)
    finally:
        tmod._dot_f32 = dot
    losses = [metrics["loss"].item()]
    for _ in range(config["warmup"] - 1):
        state, metrics = train_step(state, batch)
        losses.append(metrics["loss"].item())
    sync()
    t0 = time.perf_counter()
    timed = []
    for _ in range(config["timed"]):
        state, metrics = train_step(state, batch)
        timed.append(metrics["loss"])
    sync()
    dt = time.perf_counter() - t0
    steps = config["warmup"] + config["timed"]
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    profile = None
    if config.get("profile"):   # every rank steps: the step's collectives
        if dist.get_rank() == 0:
            _, log_dir = gpu_profiler.profile_step(
                train_step, state, batch, log_dir=config["profile"]["dir"],
                device=device)
            profile = profile_summary(
                gpu_profiler, gpu_profiler.latest_trace_dir(log_dir),
                config["profile"]["table"])
        else:
            train_step(state, batch)
    train.report({
        "world": world, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "layers": cfg.n_layers, "rows": config["rows"], "build_s": build_s,
        "losses": losses + [x.item() for x in timed],
        "grad_norm": metrics["grad_norm"].item(),
        "step_ms": dt / config["timed"] * 1e3,
        "tokens_s_card": config["rows"] * cfg.max_seq_len * config["timed"]
        / dt / world,
        "init_peak_gib": init_peak / 2**30, "peak_gib": peak / 2**30,
        "card_gib": (torch.cuda.mem_get_info()[1] / 2**30 if on_card
                     else 0.0),
        "params": sum(p.numel() for p in state["params"].values()),
        "launches_a_step": {n: c / steps for n, c in launches.items()},
        "head_widths": sorted(set(widths)),
        "embed_placements": [str(p) for p in
                             state["params"]["embed"].placements],
        "profile": profile})


def narrow_loop(config):
    """In each worker: one step of narrow_config() in bf16 on
    config["mesh"] from the CPU model's params; rank 0 holds the loss and
    every grad to the CPU f32 path's on the same tokens."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import Transformer
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step

    device = config["device"]
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = config["cfg"]
    host = Transformer(cfg.replace(dtype="float32"), "cpu", seed=SEED)
    model = Transformer(cfg, device="meta")
    model.load_state_dict({n: p.detach().to(device)
                           for n, p in host.state_dict().items()},
                          assign=True)
    mesh = make_mesh(MeshConfig(**config["mesh"]), device=device)
    init_state, train_step = make_train_step(
        lambda p, b: model.loss(b, mesh=mesh), Transformer.param_specs(cfg),
        mesh, optimizer=adamw(1e-4, weight_decay=0.1), device=device)
    state = init_state(model)
    batch = tokens_batch(cfg, config["rows"])
    fa.reset_launches()
    _, metrics = train_step(state, batch)
    launches = dict(fa.launches)
    grads = {n: p.grad.full_tensor().float().cpu()
             for n, p in state["params"].items()}
    out = {"loss": metrics["loss"].item(), "launches": launches,
           "embed_placements": [str(p) for p in
                                state["params"]["embed"].placements]}
    if dist.get_rank() == 0:
        t0 = time.perf_counter()
        torch.set_num_threads(max(1, (os.cpu_count() or 4) // 2))
        loss = host.loss({"tokens": torch.as_tensor(batch["tokens"])})
        loss.backward()
        errs = {n: ((grads[n] - p.grad).norm() / p.grad.norm()).item()
                for n, p in host.named_parameters()}
        out.update(cpu_loss=loss.item(), grad_errs=errs,
                   cpu_s=time.perf_counter() - t0)
    dist.barrier()
    train.report(out)


def fit(loop, config, name, root, use_gpu=True, backend=None):
    """TorchTrainer(loop).fit() with CARDS workers; rank 0's metrics."""
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)
    t0 = time.perf_counter()
    result = TorchTrainer(
        loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=CARDS, use_gpu=use_gpu),
        torch_config=TorchConfig(backend=backend) if backend else None,
        run_config=RunConfig(storage_path=os.path.join(root, "results"),
                             name=name)).fit()
    if result.error is not None:
        raise AssertionError(f"{name} failed: {result.error!r}")
    return dict(result.metrics, fit_s=time.perf_counter() - t0)


def run_llama(name, mesh, layers, setup, record, first=None):
    """One "llama*" phase; returns rank 0's metrics."""
    cfg = setup["llama_config"](layers)
    warm, timed = ((LLAMA_WARMUP, LLAMA_TIMED) if name == "llama32"
                   else (SHORT_WARMUP, SHORT_TIMED))
    config = {"device": setup["device"], "cfg": cfg, "mesh": mesh,
              "rows": CARDS, "warmup": warm, "timed": timed}
    if name == "llama32":
        config["profile"] = {
            "dir": tempfile.mkdtemp(prefix="multicard_trace_"),
            "table": os.path.abspath(os.path.join(
                setup["out_dir"], "multicard_llama32_profile.txt"))}
    try:
        m = fit(llama_loop, config, name, setup["root"], **setup["fit"])
    finally:
        if "profile" in config:
            shutil.rmtree(config["profile"]["dir"], ignore_errors=True)
    losses = m["losses"]
    record[name] = m
    stack, top = layer_params(cfg)
    print(f"  {name}: mesh {m['mesh']}, {m['layers']} layers, "
          f"{m['params'] / 1e9:.4f}B params ({(stack + top) / 1e9:.4f}B "
          f"reckoned); fit() {m['fit_s']:.1f} s, build {m['build_s']:.1f} "
          f"s, init peak {m['init_peak_gib']:.2f} GiB", flush=True)
    print(f"  {name}: losses {['%.4f' % x for x in losses]}, grad_norm "
          f"{m['grad_norm']:.4f}; step {m['step_ms']:.2f} ms, "
          f"{m['tokens_s_card']:.1f} tokens/s a card; peak "
          f"{m['peak_gib']:.2f} of {m['card_gib']:.2f} GiB a card; "
          f"launches a step {m['launches_a_step']}; head widths "
          f"{m['head_widths']}; embed {m['embed_placements']}; "
          f"{setup['kind']}; {setup['smi']}", flush=True)
    if m["profile"]:
        p = m["profile"]
        print(f"  {name} profiled step: {p['device_ms']:.2f} ms of device "
              f"time ({p['device_ms'] / m['step_ms']:.1%} of an unprofiled "
              f"step), busy {p['busy_ms']:.2f} ms of the profiled step's "
              f"{p['window_ms']:.2f} ms window ({p['busy_share']:.1%}: the "
              f"profiler's host cost stretches it); longest idle gaps (ms) "
              f"{[round(g, 3) for g in p['idle_gaps_ms']]}; NCCL "
              f"{json.dumps(p['nccl'])}; {setup['kind']}; {setup['smi']}",
              flush=True)
        for row in p["top"][:15]:
            print(f"    {row['ms']:10.3f} ms {row['count']:6d}  "
                  f"{row['name']}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss does not fall: {losses}")
    want = math.log(cfg.vocab_size) + 0.5
    if abs(losses[0] - want) > 0.5:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg.vocab_size}) + 1/2 = {want:.4f}")
    if first is not None and abs(losses[0] - first) > FIRST_LOSS_TOL:
        raise AssertionError(f"first loss {losses[0]} is {losses[0] - first}"
                             f" from llama32's {first}")
    per_step = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers}
    if setup["device"] == "cuda" and m["launches_a_step"] != per_step:
        raise AssertionError(f"launches a step {m['launches_a_step']}, "
                             f"expected {per_step}")
    vocab = cfg.vocab_size // mesh.get("tensor", 1)
    if [tuple(w) for w in m["head_widths"]] != [(cfg.d_model, vocab)]:
        raise AssertionError(f"the loss multiplied by heads "
                             f"{m['head_widths']}, not [d, {vocab}]")
    return m


def run_narrow(setup, record):
    cfg = setup["narrow_config"]()
    m = fit(narrow_loop, {"device": setup["device"], "cfg": cfg,
                          "mesh": dict(data=1, fsdp=2, tensor=2),
                          "rows": NARROW_ROWS}, "narrow", setup["root"],
            **setup["fit"])
    record["narrow"] = m
    loss_err = abs(m["loss"] - m["cpu_loss"]) / abs(m["cpu_loss"])
    worst = max(m["grad_errs"].items(), key=lambda kv: kv[1])
    print(f"  narrow d_model {cfg.d_model}, {cfg.n_layers} layers, vocab "
          f"{cfg.vocab_size} on {m['embed_placements']}, tokens "
          f"[{NARROW_ROWS}, {cfg.max_seq_len + 1}]: loss {cfg.dtype} "
          f"{m['loss']:.5f} vs f32 CPU {m['cpu_loss']:.5f} (rel "
          f"{loss_err:.2e}); worst grad rel norm err {worst[1]:.2e} "
          f"({worst[0]}); CPU reference {m['cpu_s']:.1f} s; launches "
          f"{m['launches']}; {setup['kind']}; {setup['smi']}", flush=True)
    if not (math.isfinite(m["loss"]) and loss_err < LOSS_TOL):
        raise AssertionError(f"loss {m['loss']} vs {m['cpu_loss']}")
    if not worst[1] < GRAD_TOL:
        raise AssertionError(f"grad {worst[0]}: relative error {worst[1]}")


def learner_buckets(ray_tpu_torch, path, since):
    """perf_report's buckets of the IMPALA learner thread (the thread
    with the most learner.step time in the cluster's span timeline),
    over the events from `since` (wall seconds) on: this process's span
    ring outlives a cluster, so an earlier run's events are still in
    it."""
    from ray_tpu_torch.tools import perf_report
    events = [e for e in ray_tpu_torch.timeline(path, spans=True)
              if e.get("ts", 0.0) >= since * 1e6]
    steps = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") == "learner.step":
            key = (e.get("pid"), e.get("tid"))
            steps[key] = steps.get(key, 0.0) + float(e.get("dur", 0.0))
    if not steps:
        raise AssertionError("no learner.step span in the IMPALA timeline")
    pid, tid = max(steps, key=steps.get)
    report = perf_report.attribute(events, process=str(pid), thread=str(tid))
    return {"window_s": report["window_s"],
            "buckets": {b: round(r["pct"], 2)
                        for b, r in report["buckets"].items()}}


def impala_minipong(ray_tpu_torch, num_learners, setup):
    """IMPALA MiniPong for IMPALA_S s of algo.train(), then drained; the
    throughput, the last stats and (for a gang) every rank's weights."""
    import numpy as np

    from ray_tpu_torch.rllib import ImpalaConfig
    config = (ImpalaConfig().environment("MiniPong-v0")
              .env_runners(num_env_runners=IMPALA_RUNNERS,
                           num_envs_per_env_runner=IMPALA_ENVS,
                           rollout_fragment_length=IMPALA_T)
              .learners(num_learners=num_learners,
                        device=setup["learner_device"])
              .debugging(seed=SEED))
    t0 = time.perf_counter()
    algo = config.build()
    build_s = time.perf_counter() - t0
    try:
        results = []
        since = time.time()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < IMPALA_S:
            results.append(algo.train())
        wall = time.perf_counter() - t0
        deadline = time.perf_counter() + 120
        last = None
        while True:   # drained: the queue empty, no update for 1 s
            if algo._learner_error is not None:
                raise algo._learner_error
            with algo._stats_lock:
                now = (algo._steps_trained, algo._updates_done)
            if algo._train_queue.empty() and now == last:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"the learner did not drain: {now}")
            last = now
            time.sleep(1.0)
        trained, updates = now
        sampled = algo._timesteps_total
        with algo._stats_lock:
            stats = dict(algo._learner_stats)
        group = algo.learner_group
        ranks = (ray_tpu_torch.get([a.get_weights.remote()
                                    for a in group._actors], timeout=300)
                 if num_learners else [group.get_weights()])
    finally:
        algo.stop()
    equal = all(np.array_equal(w[k], ranks[0][k]) for w in ranks[1:]
                for k in ranks[0])
    return {"learners": max(num_learners, 1), "build_s": build_s,
            "wall_s": wall, "iterations": len(results), "since": since,
            "sampled_s": sampled / wall, "trained": trained,
            "updates": updates, "trained_s": trained / wall,
            "updates_s": updates / wall, "stats": stats,
            "ranks_equal": equal}


def impala_cartpole(num_learners, setup):
    """The JAX package's test_impala_cartpole_mesh_learners config with
    num_learners learners: (best episode_reward_mean, iterations, s)."""
    import numpy as np

    from ray_tpu_torch.rllib import ImpalaConfig
    config = (ImpalaConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                           rollout_fragment_length=32)
              .training(train_batch_size=512, lr=5e-3, entropy_coeff=0.003,
                        vf_loss_coeff=0.25)
              .learners(num_learners=num_learners,
                        device=setup["learner_device"])
              .debugging(seed=SEED))
    algo = config.build()
    t0 = time.perf_counter()
    best, iterations = -np.inf, 0
    try:
        while time.perf_counter() - t0 < CARTPOLE_DEADLINE_S:
            result = algo.train()
            iterations += 1
            best = max(best, result.get("episode_reward_mean", -np.inf))
            if best >= CARTPOLE_BAR:
                break
    finally:
        algo.stop()
    return best, iterations, time.perf_counter() - t0


def run_impala(setup, record):
    """Phase "impala4": each run in a cluster of its own, so that each
    span timeline holds its own learner thread only."""
    import ray_tpu_torch
    runs = {}
    record["impala4"] = runs
    host_load()
    for learners in (CARDS, 0, "cartpole"):
        root = tempfile.mkdtemp(prefix="multicard_impala_")
        try:
            ray_tpu_torch.init(num_cpus=IMPALA_RUNNERS + CARDS + 2,
                               _session_root=root)
            if learners == "cartpole":
                best, iterations, secs = impala_cartpole(CARDS, setup)
            else:
                run = impala_minipong(ray_tpu_torch, learners, setup)
                run["perf_report"] = learner_buckets(
                    ray_tpu_torch, os.path.join(root, "spans.json"),
                    run["since"])
        finally:
            ray_tpu_torch.shutdown()
            shutil.rmtree(root, ignore_errors=True)
        if learners == "cartpole":
            runs["cartpole"] = {"learners": CARDS, "best": best,
                                "iterations": iterations, "s": secs}
            print(f"  IMPALA CartPole, {CARDS} learners: best {best:.1f} in "
                  f"{iterations} iterations, {secs:.1f} s (bar "
                  f"{CARTPOLE_BAR:g}); {setup['kind']}; {setup['smi']}",
                  flush=True)
            if not best >= CARTPOLE_BAR:
                raise AssertionError(f"IMPALA CartPole with {CARDS} "
                                     f"learners plateaued at {best}")
            continue
        runs[run["learners"]] = run
        print(f"  impala MiniPong, {run['learners']} learner(s), R = "
              f"{IMPALA_RUNNERS}: build {run['build_s']:.2f} s; "
              f"{run['iterations']} iterations in {run['wall_s']:.2f} s; env "
              f"steps sampled {run['sampled_s']:.1f}/s, trained "
              f"{run['trained']} ({run['trained_s']:.1f}/s), "
              f"{run['updates']} updates ({run['updates_s']:.2f}/s); ranks' "
              f"weights equal {run['ranks_equal']}; learner thread "
              f"{json.dumps(run['perf_report'])}; last stats "
              f"{json.dumps(run['stats'])}; {setup['kind']}; {setup['smi']}",
              flush=True)
        if not (run["updates"] > 0 and run["trained"] == 500
                * run["updates"]):
            raise AssertionError(f"trained {run['trained']} in "
                                 f"{run['updates']} updates")
        if not all(math.isfinite(v) for v in run["stats"].values()):
            raise AssertionError(f"stats {run['stats']}")
        if not run["ranks_equal"]:
            raise AssertionError("the learners' weights differ after the "
                                 "last update")


def host_load():
    """Print the host's load average and its busiest processes (the
    runners' sampling pace is the host's)."""
    import subprocess
    ps = subprocess.run(["ps", "-eo", "pcpu,rss,etimes,args",
                         "--sort=-pcpu"], capture_output=True, text=True)
    busiest = [line[:160] for line in ps.stdout.splitlines()[1:6]]
    print(f"  host: {os.cpu_count()} cores, load average "
          f"{os.getloadavg()}; busiest processes (%CPU, RSS KiB, s): "
          f"{busiest}", flush=True)


def run_phases(setup, only):
    """Every phase in `only`, each failure printed and counted; returns
    (record, failed phases)."""
    import ray_tpu_torch
    record, failed = {}, []

    def phase(name, fn):
        if name not in only:
            return
        t0 = time.perf_counter()
        print(f"[{name}] ...", flush=True)
        try:
            fn()
            print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:  # noqa: BLE001 - every phase runs; exit 1 after
            traceback.print_exc()
            print(f"[{name}] FAILED ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            failed.append(name)

    def llama_phases():
        ray_tpu_torch.init(num_cpus=CARDS + 1, _session_root=setup["root"])
        try:
            phase("llama32", lambda: run_llama(
                "llama32", dict(data=1, fsdp=CARDS), 32, setup, record))
            first = record.get("llama32", {}).get("losses", [None])[0]
            phase("llama_tp", lambda: run_llama(
                "llama_tp", dict(data=1, fsdp=2, tensor=2), 32, setup,
                record, first=first))
            phase("llama_dp", lambda: run_llama(
                "llama_dp", dict(data=2, fsdp=2), LLAMA_DP_LAYERS, setup,
                record))
            phase("narrow", lambda: run_narrow(setup, record))
        finally:
            ray_tpu_torch.shutdown()

    if set(only) & {"llama32", "llama_tp", "llama_dp", "narrow"}:
        llama_phases()
    phase("impala4", lambda: run_impala(setup, record))
    return record, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="multicard.json")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    if set(only) - set(PHASES):
        ap.error(f"unknown phases {set(only) - set(PHASES)}")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() != CARDS:
        raise RuntimeError(f"chip_multicard needs {CARDS} CUDA cards; "
                           f"{torch.cuda.device_count()} visible")
    from ray_tpu_torch._device import gpu_info
    from ray_tpu_torch.ops import _build
    kind, smi = torch.cuda.get_device_name(0), gpu_info()
    print(f"{CARDS} x {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build()   # once here, before the workers load the kernels
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_multicard_")
    setup = {"device": "cuda", "learner_device": None, "kind": kind,
             "smi": smi, "root": root, "out_dir": out_dir, "fit": {},
             "llama_config": llama_config, "narrow_config": narrow_config}
    t0 = time.perf_counter()
    try:
        record, failed = run_phases(setup, only)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record.update(device={"kind": kind, "smi": smi, "count": CARDS},
                  seconds=time.perf_counter() - t0, failed=failed)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps({"ok": not failed, "failed": failed,
                      "seconds": round(record["seconds"], 1)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
