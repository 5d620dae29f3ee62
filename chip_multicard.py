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
- "nodes": the north star's multi-host layout on one host: a Cluster of
  its own whose in-process head holds no GPU, and two node managers
  started under CUDA_VISIBLE_DEVICES "0,1" and "2,3" (NODE_CARDS), two
  cards each, as two hosts of two cards. LLAMA2_7B as in "llama32" on
  make_multislice_mesh(2 x (fsdp=2)), the node ids all-gathered from the
  runtime, the batch over ("dcn", "data", "fsdp"): FSDP inside a node,
  the grads reduced over "dcn" across nodes. Four ranks on four distinct
  cards (PCI bus ids) under two node ids, each node's ranks one dcn row;
  NODES_WARMUP + NODES_TIMED steps, each loss within FIRST_LOSS_TOL of
  "llama_dp"'s (the same math on data=2 x fsdp=2 under one node manager,
  run first whenever "nodes" runs); launches exactly 2/1/1 a layer a step
  on every rank; fit() to the first step; one profiled step's
  collectives by mesh axis (calls and bytes from the step's own
  collective calls, device ms from NCCL's kernels on each process
  group's stream); the transport NCCL chose within and across the nodes
  (NCCL_DEBUG=INFO). On one host the "dcn" link is NVLink: no number of
  this phase stands for two hosts.
- "nodes_narrow": narrow_config() for one step on the same layout,
  against the CPU f32 path at "narrow"'s bars.
- "nodes_rl": on a Cluster of the same layout whose nodes hold one CPU
  each, so that a gang's ranks and ES's actors go one a node: the
  two-policy PPO learner gang (MultiAgentPPOLearner, two NCCL ranks, one
  a node, each pulling its batch from the head's object store) against
  one learner on the card from the same batch and seed (the ranks'
  weights equal to the bit; total_loss rtol 1e-4, weights 1e-5); then ES
  with two evaluation actors, one on each node, against num_workers=0:
  the same theta after ES_ITERS iterations.

Each number is printed with the card's name and power limit
(nvidia-smi); --out writes every phase's record as JSON, and the
profiled step's table goes beside it (multicard_llama32_profile.txt).
"""

from __future__ import annotations

import argparse
import contextlib
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
# "nodes": two node managers of two cards each on the four-card host
NODE_CARDS = ("0,1", "2,3")
NODES_WARMUP, NODES_TIMED = 3, 4      # "nodes" and "llama_dp"
# "nodes_rl": the two-policy PPO gang's batch and bars, ES's run
PPO_ROWS = {"pol_a": 4096, "pol_b": 2048}
PPO_ITERS, PPO_LOSS_RTOL, PPO_WEIGHT_TOL = 3, 1e-4, 1e-5
ES_ITERS = 2
PHASES = ("llama32", "llama_tp", "llama_dp", "narrow", "impala4", "nodes",
          "nodes_narrow", "nodes_rl")


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


def build_mesh(config, device):
    """(mesh, rules): config["mesh"] through make_mesh, or with
    config["slices"] a multi-slice mesh of that many slices over it (the
    node ids all-gathered from the runtime), the batch over ("dcn",
    "data", "fsdp")."""
    from ray_tpu_torch.parallel import (MeshConfig, MultiSliceConfig,
                                        ShardingRules, make_mesh,
                                        make_multislice_mesh)
    per = MeshConfig(**config["mesh"])
    if not config.get("slices"):
        return make_mesh(per, device=device), None
    mesh = make_multislice_mesh(MultiSliceConfig(config["slices"], per),
                                device=device)
    return mesh, ShardingRules().replace(batch=("dcn", "data", "fsdp"))


def rank_info(torch, mesh):
    """Every rank's node (the runtime's id), CUDA_VISIBLE_DEVICES, card
    (its PCI bus id) and mesh coordinate, all-gathered."""
    import torch.distributed as dist

    from ray_tpu_torch import get_runtime_context
    bus = None
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        bus = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
               f"{props.pci_device_id:02x}.0")
    me = {"rank": dist.get_rank(),
          "node": get_runtime_context().get_node_id(),
          "cards": os.environ.get("CUDA_VISIBLE_DEVICES"), "bus": bus,
          "coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))}
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, me)
    return out


KINDS = ("AllGather", "ReduceScatter", "AllReduce")


@contextlib.contextmanager
def collectives_by_axis(mesh):
    """Counts, inside the block, this rank's collective calls of the
    sharded step by mesh axis and kind: calls, bytes (the full tensor's:
    an all-gather's output, a reduce-scatter's input, an all-reduce's
    tensor) and how many of the calls were synchronous dist.all_reduce
    (the loss and the grad norm). Yields the dict it fills, {axis:
    {kind: {"calls", "bytes", "sync"}}}; the world group is axis
    "world"."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import sharding
    axis_of = {tuple(sorted(dist.get_process_group_ranks(
        mesh.get_group(a)))): a for a, n in zip(mesh.mesh_dim_names,
                                                mesh.shape) if n > 1}
    world = tuple(range(dist.get_world_size()))
    counts = {}

    def count(kind, group, nbytes, sync=False):
        ranks = (world if group is None else
                 tuple(sorted(dist.get_process_group_ranks(group))))
        axis = axis_of.get(ranks, "world" if ranks == world else str(ranks))
        row = counts.setdefault(axis, {}).setdefault(
            kind, {"calls": 0, "bytes": 0, "sync": 0})
        row["calls"] += 1
        row["bytes"] += nbytes
        row["sync"] += sync

    def size(x):
        return x.numel() * x.element_size()

    gather, scatter, reduce = (sharding._all_gather,
                               sharding._reduce_scatter,
                               sharding._all_reduce)
    all_reduce = dist.all_reduce

    def counted_gather(x, dim, group):
        count("AllGather", group,
              size(x) * dist.get_world_size(group))
        return gather(x, dim, group)

    def counted_scatter(x, dim, group):
        count("ReduceScatter", group, size(x))
        return scatter(x, dim, group)

    def counted_reduce(x, group, op="sum"):
        count("AllReduce", group, size(x))
        return reduce(x, group, op)

    def counted_all_reduce(tensor, *args, group=None, **kwargs):
        count("AllReduce", group, size(tensor), sync=True)
        return all_reduce(tensor, *args, group=group, **kwargs)

    sharding._all_gather, sharding._reduce_scatter = (counted_gather,
                                                      counted_scatter)
    sharding._all_reduce, dist.all_reduce = (counted_reduce,
                                             counted_all_reduce)
    try:
        yield counts
    finally:
        sharding._all_gather, sharding._reduce_scatter = gather, scatter
        sharding._all_reduce, dist.all_reduce = reduce, all_reduce


def nccl_by_stream(run):
    """NCCL's kernels of one capture by CUDA stream: {stream: {kind:
    {"count", "ms"}}}. Each process group runs its collectives on a
    stream of its own."""
    import glob

    from ray_tpu_torch.util import gpu_profiler
    path = sorted(glob.glob(os.path.join(
        run, "*" + gpu_profiler.TRACE_SUFFIX)))[0]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel" or \
                not e.get("name", "").lower().startswith("nccl"):
            continue
        kind = next((k for k in KINDS if k.lower() in e["name"].lower()),
                    "other")
        stream = str((e.get("args") or {}).get("stream", e.get("tid")))
        row = out.setdefault(stream, {}).setdefault(
            kind, {"count": 0, "ms": 0.0})
        row["count"] += 1
        row["ms"] += float(e.get("dur", 0.0)) / 1e3
    return out


def axes_of_streams(calls, streams):
    """{axis: {kind: {"calls", "bytes", "count", "ms"}}}: each NCCL
    stream's kernels under the axis whose asynchronous calls by kind it
    matches (a process group's own stream). The synchronous calls run on
    the caller's stream: a stream that matches them all is "sync"; one
    that matches nothing stays "stream N"."""
    out = {a: {k: {"calls": r["calls"], "bytes": r["bytes"]}
               for k, r in kinds.items()} for a, kinds in calls.items()}
    own = {a: {k: r["calls"] - r["sync"] for k, r in kinds.items()
               if r["calls"] > r["sync"]} for a, kinds in calls.items()}
    sync = {}
    for kinds in calls.values():
        for k, r in kinds.items():
            if r["sync"]:
                sync[k] = sync.get(k, 0) + r["sync"]
    for stream, kinds in streams.items():
        got = {k: r["count"] for k, r in kinds.items()}
        axis = next((a for a, want in own.items() if want == got),
                    "sync" if got == sync else f"stream {stream}")
        for k, r in kinds.items():
            out.setdefault(axis, {}).setdefault(k, {}).update(r)
    return out


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
    mesh, rules = build_mesh(config, device)
    init_state, train_step = make_train_step(
        lambda p, b: model.loss(b, mesh=mesh, rules=rules),
        Transformer.param_specs(cfg), mesh,
        optimizer=adamw(1e-4, weight_decay=0.1), rules=rules, device=device)
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
    first_step_at = time.time()
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
    ranks = rank_info(torch, mesh)
    every = [None] * world
    dist.all_gather_object(every, {n: c / steps for n, c in launches.items()})
    profile = None
    if config.get("profile"):   # every rank steps: the step's collectives
        if dist.get_rank() == 0:
            with collectives_by_axis(mesh) as calls:
                _, log_dir = gpu_profiler.profile_step(
                    train_step, state, batch,
                    log_dir=config["profile"]["dir"], device=device)
            run = gpu_profiler.latest_trace_dir(log_dir)
            profile = profile_summary(gpu_profiler, run,
                                      config["profile"]["table"])
            profile["axes"] = axes_of_streams(
                calls, nccl_by_stream(run) if on_card else {})
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
        "ranks": ranks, "launches_by_rank": every,
        "dcn_rows": (mesh.mesh.reshape(config["slices"], -1).tolist()
                     if config.get("slices") else None),
        "first_step_at": first_step_at,
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
    mesh, rules = build_mesh(config, device)
    init_state, train_step = make_train_step(
        lambda p, b: model.loss(b, mesh=mesh, rules=rules),
        Transformer.param_specs(cfg), mesh,
        optimizer=adamw(1e-4, weight_decay=0.1), rules=rules, device=device)
    state = init_state(model)
    batch = tokens_batch(cfg, config["rows"])
    fa.reset_launches()
    _, metrics = train_step(state, batch)
    launches = dict(fa.launches)
    grads = {n: p.grad.full_tensor().float().cpu()
             for n, p in state["params"].items()}
    out = {"loss": metrics["loss"].item(), "launches": launches,
           "embed_placements": [str(p) for p in
                                state["params"]["embed"].placements],
           "ranks": rank_info(torch, mesh)}
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
    t0, wall = time.perf_counter(), time.time()
    result = TorchTrainer(
        loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=CARDS, use_gpu=use_gpu),
        torch_config=TorchConfig(backend=backend) if backend else None,
        run_config=RunConfig(storage_path=os.path.join(root, "results"),
                             name=name)).fit()
    if result.error is not None:
        raise AssertionError(f"{name} failed: {result.error!r}")
    return dict(result.metrics, fit_s=time.perf_counter() - t0,
                fit_wall=wall)


def run_llama(name, mesh, layers, setup, record, first=None, slices=None):
    """One "llama*" phase (or "nodes": `slices` slices of `mesh`);
    returns rank 0's metrics."""
    cfg = setup["llama_config"](layers)
    warm, timed = {"llama32": (LLAMA_WARMUP, LLAMA_TIMED),
                   "llama_dp": (NODES_WARMUP, NODES_TIMED),
                   "nodes": (NODES_WARMUP, NODES_TIMED)}.get(
                       name, (SHORT_WARMUP, SHORT_TIMED))
    config = {"device": setup["device"], "cfg": cfg, "mesh": mesh,
              "slices": slices, "rows": CARDS, "warmup": warm,
              "timed": timed}
    if name in ("llama32", "nodes"):
        config["profile"] = {
            "dir": tempfile.mkdtemp(prefix="multicard_trace_"),
            "table": os.path.abspath(os.path.join(
                setup["out_dir"], f"multicard_{name}_profile.txt"))}
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
    if setup["device"] == "cuda" and any(
            r != per_step for r in m["launches_by_rank"]):
        raise AssertionError(f"launches a step a rank "
                             f"{m['launches_by_rank']}, expected {per_step}")
    vocab = cfg.vocab_size // mesh.get("tensor", 1)
    if [tuple(w) for w in m["head_widths"]] != [(cfg.d_model, vocab)]:
        raise AssertionError(f"the loss multiplied by heads "
                             f"{m['head_widths']}, not [d, {vocab}]")
    return m


def run_narrow(setup, record, name="narrow",
               mesh=dict(data=1, fsdp=2, tensor=2), slices=None):
    """Phase "narrow" (or "nodes_narrow": `slices` slices of `mesh`);
    returns rank 0's metrics."""
    cfg = setup["narrow_config"]()
    m = fit(narrow_loop, {"device": setup["device"], "cfg": cfg,
                          "mesh": mesh, "slices": slices,
                          "rows": NARROW_ROWS}, name, setup["root"],
            **setup["fit"])
    record[name] = m
    loss_err = abs(m["loss"] - m["cpu_loss"]) / abs(m["cpu_loss"])
    worst = max(m["grad_errs"].items(), key=lambda kv: kv[1])
    print(f"  {name} d_model {cfg.d_model}, {cfg.n_layers} layers, vocab "
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
    return m


@contextlib.contextmanager
def node_cluster(cpus, env=None):
    """A Cluster of its own, connected for the block: the in-process head
    with no GPU and no CPU, and one node manager for each entry of
    NODE_CARDS, started under CUDA_VISIBLE_DEVICES of those cards (and
    `env`), with `cpus` CPUs. Yields the nodes' ids in NODE_CARDS'
    order."""
    from ray_tpu_torch.cluster_utils import Cluster
    cluster = Cluster(head_node_args={"num_cpus": 0, "resources": {"GPU": 0}})
    try:
        nodes = [cluster.add_node(num_cpus=cpus, env=dict(
            env or {}, CUDA_VISIBLE_DEVICES=cards)).node_id_hex
            for cards in NODE_CARDS]
        cluster.connect()
        yield nodes
    finally:
        cluster.shutdown()


def check_layout(ranks, nodes, dcn_rows, on_card):
    """Raises unless the ranks sit two a node on the nodes `nodes` (in
    NODE_CARDS' order), each seeing one card of its node's (on the card:
    four distinct PCI bus ids), and each dcn row is one node's ranks."""
    node_of = {r["rank"]: r["node"] for r in ranks}
    for i, node in enumerate(nodes):
        mine = [r for r in ranks if r["node"] == node]
        cards = sorted(r["cards"] for r in mine)
        if len(mine) != CARDS // len(nodes) or not set(cards) <= set(
                NODE_CARDS[i].split(",")):
            raise AssertionError(f"node {i} ({node[:8]}) holds ranks "
                                 f"{mine}, not two of cards {NODE_CARDS[i]}")
    if set(node_of.values()) != set(nodes):
        raise AssertionError(f"the ranks' nodes {sorted(node_of.values())} "
                             f"are not the cluster's {nodes}")
    if on_card and len({r["bus"] for r in ranks}) != CARDS:
        raise AssertionError(f"the ranks' cards are not {CARDS} distinct "
                             f"ones: {[r['bus'] for r in ranks]}")
    if dcn_rows is not None:
        rows = [{node_of[r] for r in row} for row in dcn_rows]
        if any(len(row) != 1 for row in rows) or rows[0] == rows[1]:
            raise AssertionError(f"the dcn rows {dcn_rows} are not the "
                                 f"nodes' ranks ({node_of})")


NCCL_ENV = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,P2P,SHM,NET"}


def nccl_transports(log_dir):
    """What NCCL_DEBUG=INFO's channel lines ("Channel 00/0 : 0[2] -> 1[3]
    via P2P/CUMEM", the brackets holding the cards' indices) say each
    connection took, within a node and across nodes, and the node counts
    NCCL itself found ("nNodes N")."""
    import glob
    import re
    chan = re.compile(r"Channel \d+/\d+ : \d+\[(\w+)\] -> \d+\[(\w+)\] "
                      r"via (\S+)")
    node_of = {}
    for i, cards in enumerate(NODE_CARDS):
        node_of.update({c: i for c in cards.split(",")})
    out = {"within": {}, "across": {}, "unknown": {}, "nNodes": [],
           "sample": []}
    for path in sorted(glob.glob(os.path.join(log_dir, "nccl.*"))):
        with open(path, errors="replace") as f:
            for line in f:
                hit = re.search(r"nNodes (\d+)", line)
                if hit and int(hit.group(1)) not in out["nNodes"]:
                    out["nNodes"].append(int(hit.group(1)))
                hit = chan.search(line)
                if not hit:
                    continue
                a, b, via = hit.groups()
                na, nb = node_of.get(a), node_of.get(b)
                where = ("unknown" if na is None or nb is None else
                         "within" if na == nb else "across")
                out[where][via] = out[where].get(via, 0) + 1
                if len(out["sample"]) < 4:
                    out["sample"].append(line.strip()[-120:])
    return out


def run_nodes(setup, record):
    """Phase "nodes": the 7B on 2 x (fsdp=2) over two node managers."""
    reference = record.get("llama_dp", {}).get("losses")
    if reference is None:
        raise AssertionError("phase llama_dp gave no losses to hold "
                             "nodes' to")
    nccl_dir = tempfile.mkdtemp(prefix="multicard_nccl_")
    env = dict(NCCL_ENV, NCCL_DEBUG_FILE=os.path.join(nccl_dir,
                                                     "nccl.%h.%p.log"))
    try:
        with node_cluster(cpus=CARDS // len(NODE_CARDS), env=env) as nodes:
            m = run_llama("nodes", dict(data=1, fsdp=2), LLAMA_DP_LAYERS,
                          setup, record, slices=len(NODE_CARDS))
        transports = nccl_transports(nccl_dir)
        shutil.copytree(nccl_dir, os.path.join(setup["out_dir"],
                                               "multicard_nccl"),
                        dirs_exist_ok=True)
    finally:
        shutil.rmtree(nccl_dir, ignore_errors=True)
    m["nccl_transports"] = transports
    first_s = m["first_step_at"] - m["fit_wall"]
    print(f"  nodes: ranks (rank, node, CUDA_VISIBLE_DEVICES, bus id) "
          f"{[(r['rank'], r['node'][:8], r['cards'], r['bus']) for r in m['ranks']]}"
          f"; nodes {[n[:8] for n in nodes]}; dcn rows {m['dcn_rows']}; "
          f"fit() to the first step {first_s:.1f} s; launches a step a "
          f"rank {m['launches_by_rank']}", flush=True)
    losses = m["losses"]
    print(f"  nodes vs llama_dp, each step's loss: "
          f"{[('%.4f' % a, '%.4f' % b) for a, b in zip(losses, reference)]}"
          f"; {setup['kind']}; {setup['smi']}", flush=True)
    axes = (m["profile"] or {}).get("axes", {})
    for axis, kinds in axes.items():
        print(f"  nodes profiled step, axis {axis}: " + "; ".join(
            f"{k} {r.get('calls', '-')} calls, "
            f"{r.get('bytes', 0) / 2**20:.1f} MiB, {r.get('count', '-')} "
            f"kernels, {r.get('ms', 0.0):.3f} ms" for k, r in kinds.items())
            + f"; {setup['kind']}; {setup['smi']}", flush=True)
    print(f"  nodes NCCL transports: {json.dumps(transports)} (one host: "
          f"the dcn link is NVLink)", flush=True)
    check_layout(m["ranks"], nodes, m["dcn_rows"],
                 setup["device"] == "cuda")
    if len(losses) != len(reference) or any(
            abs(a - b) > FIRST_LOSS_TOL for a, b in zip(losses, reference)):
        raise AssertionError(f"nodes' losses {losses} are not within "
                             f"{FIRST_LOSS_TOL} of llama_dp's {reference}")
    if not (axes.get("fsdp", {}).get("AllGather", {}).get("bytes")
            and axes.get("dcn", {}).get("AllReduce", {}).get("bytes")):
        raise AssertionError(f"the profiled step moved no fsdp gather or "
                             f"no dcn reduction: {axes}")
    return m


def run_nodes_narrow(setup, record):
    """Phase "nodes_narrow": narrow_config() on the "nodes" layout."""
    with node_cluster(cpus=CARDS // len(NODE_CARDS)) as nodes:
        m = run_narrow(setup, record, name="nodes_narrow",
                       mesh=dict(data=1, fsdp=2), slices=len(NODE_CARDS))
    print(f"  nodes_narrow: ranks (rank, node, CUDA_VISIBLE_DEVICES, bus "
          f"id) {[(r['rank'], r['node'][:8], r['cards'], r['bus']) for r in m['ranks']]}",
          flush=True)
    check_layout(m["ranks"], nodes, None, setup["device"] == "cuda")


def ppo_batch(sizes, seed):
    """A two-policy PPO batch {module_id: columns} of CartPole's shapes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {mid: {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "value_targets": rng.standard_normal(n).astype(np.float32),
        "action_logp": (-0.7 + 0.1 * rng.standard_normal(n)).astype(
            np.float32),
        "vf_preds": rng.standard_normal(n).astype(np.float32)}
        for mid, n in sizes.items()}


def ppo_gang(ray_tpu_torch, setup, nodes):
    """The two-policy PPO gang, one rank a node, against one learner on
    the learners' device, PPO_ITERS full-batch steps of one batch."""
    import functools

    import numpy as np

    from ray_tpu_torch.rllib import (DiscreteMLPModule, LearnerGroup,
                                     MultiAgentRLModule, PPOConfig)
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import MultiAgentPPOLearner
    module = MultiAgentRLModule({m: DiscreteMLPModule(4, 2, (64, 64))
                                 for m in PPO_ROWS})
    cfg = PPOConfig().training(lr=1e-2).learners(
        device=setup["learner_device"])
    factory = functools.partial(MultiAgentPPOLearner, module, cfg)
    batch = ppo_batch(PPO_ROWS, SEED)
    local = LearnerGroup(factory, num_learners=0, seed=5)
    t0 = time.perf_counter()
    s_local = local.update(batch, minibatch_size=None, num_iters=PPO_ITERS,
                           seed=SEED)
    local_s = time.perf_counter() - t0
    w_local = local.get_weights()
    t0 = time.perf_counter()
    gang = LearnerGroup(factory, num_learners=2, seed=5)
    form_s = time.perf_counter() - t0
    try:
        where = ray_tpu_torch.get([a.node_id.remote() for a in gang._actors],
                                  timeout=60)
        devices = ray_tpu_torch.get([a.device_report.remote()
                                     for a in gang._actors], timeout=60)
        t0 = time.perf_counter()
        s_gang = gang.update(batch, minibatch_size=None, num_iters=PPO_ITERS,
                             seed=SEED)
        gang_s = time.perf_counter() - t0
        ranks = ray_tpu_torch.get([a.get_weights.remote()
                                   for a in gang._actors], timeout=120)
    finally:
        gang.shutdown()
    equal = all(np.array_equal(ranks[1][k], ranks[0][k]) for k in ranks[0])
    diff = max(float(np.abs(w_local[k] - ranks[0][k]).max()) for k in w_local)
    loss_err = abs(s_gang["total_loss"] - s_local["total_loss"]) / abs(
        s_local["total_loss"])
    print(f"  nodes_rl PPO: the gang's ranks on nodes "
          f"{[nodes.index(w) if w in nodes else w for w in where]}, "
          f"{devices}; formed in {form_s:.1f} s; {PPO_ITERS} steps of "
          f"{PPO_ROWS} rows: gang {gang_s:.2f} s, one learner "
          f"{local_s:.2f} s; total_loss {s_gang['total_loss']:.6f} vs "
          f"{s_local['total_loss']:.6f} (rel {loss_err:.2e}), grad_norm "
          f"{s_gang['grad_norm']:.6f} vs {s_local['grad_norm']:.6f}; "
          f"weights max |gang - one| {diff:.2e}; ranks equal {equal}; "
          f"{setup['kind']}; {setup['smi']}", flush=True)
    if sorted(where) != sorted(nodes):
        raise AssertionError(f"the gang's ranks sit on {where}, not one on "
                             f"each of {nodes}")
    if not equal:
        raise AssertionError("the two ranks' weights differ")
    if not (loss_err <= PPO_LOSS_RTOL and diff <= PPO_WEIGHT_TOL):
        raise AssertionError(f"the gang is {loss_err} (total_loss) and "
                             f"{diff} (weights) from one learner")
    return {"nodes": where, "devices": devices, "form_s": form_s,
            "gang_s": gang_s, "local_s": local_s, "loss_err": loss_err,
            "weight_diff": diff}


def es_across_nodes(setup, nodes):
    """ES with two evaluation actors, one on each node, against the local
    evaluation: the same theta after ES_ITERS iterations."""
    import numpy as np

    from ray_tpu_torch.rllib import ESConfig
    from ray_tpu_torch.util import state as state_api

    def config(workers):
        return (ESConfig().environment("CartPole-v1")
                .training(lr=0.03, sigma=0.1, num_perturbations=8,
                          episode_horizon=200, num_workers=workers)
                .rl_module(model_hiddens=(32, 32)).debugging(seed=SEED)
                .learners(device=setup["learner_device"]))

    local, remote = config(0).build(), config(2).build()
    try:
        t0 = time.perf_counter()
        for _ in range(ES_ITERS):
            local.train()
        local_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(ES_ITERS):
            remote.train()
        remote_s = time.perf_counter() - t0
        actors = sorted(a["node_id"] for a in state_api.list_actors(
            {"class_name": "ESEvalWorker", "state": "ALIVE"}))
        equal = np.array_equal(remote._theta, local._theta)
        diff = float(np.abs(remote._theta - local._theta).max())
    finally:
        remote.stop()
        local.stop()
    print(f"  nodes_rl ES: actors on nodes "
          f"{[nodes.index(a) if a in nodes else a for a in actors]}; "
          f"{ES_ITERS} iterations: two actors {remote_s:.2f} s, local "
          f"{local_s:.2f} s; theta equal {equal} (max diff {diff:.2e}); "
          f"{setup['kind']}; {setup['smi']}", flush=True)
    if actors != sorted(nodes):
        raise AssertionError(f"ES's actors sit on {actors}, not one on each "
                             f"of {nodes}")
    if not equal:
        raise AssertionError(f"ES's theta with two actors is {diff} from "
                             f"num_workers=0's")
    return {"actors": actors, "remote_s": remote_s, "local_s": local_s}


def run_nodes_rl(setup, record):
    """Phase "nodes_rl": one CPU a node, so that the gang's ranks and ES's
    actors take one node each."""
    import ray_tpu_torch
    with node_cluster(cpus=1) as nodes:
        record["nodes_rl"] = {"ppo": ppo_gang(ray_tpu_torch, setup, nodes),
                              "es": es_across_nodes(setup, nodes)}


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

    if "nodes" in only and "llama_dp" not in only:
        print("  phase nodes holds its losses to llama_dp's: llama_dp runs "
              "too", flush=True)
        only = [*only, "llama_dp"]
    if set(only) & {"llama32", "llama_tp", "llama_dp", "narrow"}:
        llama_phases()
    phase("impala4", lambda: run_impala(setup, record))
    phase("nodes", lambda: run_nodes(setup, record))
    phase("nodes_narrow", lambda: run_nodes_narrow(setup, record))
    phase("nodes_rl", lambda: run_nodes_rl(setup, record))
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
