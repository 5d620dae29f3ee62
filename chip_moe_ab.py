#!/usr/bin/env python3
"""Phase "parallel"'s MoE step of chip_smoke.py, timed for two copies of
the package on one card.

    python3 chip_moe_ab.py --roots OLD . OLD . [--out FILE]

Each root is a directory that holds a ray_tpu_torch package (`.` this
checkout; OLD, say, another version unpacked into a git-ignored
directory). Each run is a process of its own that imports the package
from its root: LLAMA2_7B cut to 2 layers of 8 experts (top-2, capacity
factor 1.25, attention "auto"), random weights from SEED, on
MeshConfig(data=1, expert=-1) over a one-rank NCCL group, through
make_train_step with Transformer.param_specs and AdamW(1e-4, weight
decay 0.1), one row of 4,097 tokens (numpy, from SEED): WARMUP steps,
then TIMED steps between CUDA syncs, as chip_smoke.py's parallel_loop
takes them. Prints each run's step ms, losses and peak memory beside the
card's name and power limit, and writes them as JSON to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 0
WARMUP, TIMED = 2, 10


def one(root: str) -> dict:
    """One root's run, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import torch.distributed as dist

    import ray_tpu_torch
    from ray_tpu_torch.models import LLAMA2_7B, Transformer
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step

    where = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
    if where != os.path.join(os.path.abspath(root), "ray_tpu_torch"):
        raise RuntimeError(f"imported the package from {where}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        cfg = LLAMA2_7B.replace(n_layers=2, moe_experts=8, moe_top_k=2,
                                attention_impl="auto")
        model = Transformer(cfg, seed=SEED)
        mesh = make_mesh(MeshConfig(data=1, expert=-1))
        init_state, train_step = make_train_step(
            lambda p, b: model.loss(b, mesh=mesh),
            Transformer.param_specs(cfg), mesh,
            optimizer=adamw(1e-4, weight_decay=0.1))
        state = init_state(model)
        batch = {"tokens": np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (1, LLAMA2_7B.max_seq_len + 1))}
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for _ in range(WARMUP):
            state, metrics = train_step(state, batch)
            losses.append(metrics["loss"].item())
        steps = []
        for _ in range(TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
        return {"root": root, "step_ms": sorted(steps)[len(steps) // 2],
                "mean_ms": sum(steps) / len(steps), "steps_ms": steps,
                "losses": losses,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.one:
        print("RESULT " + json.dumps(one(args.one)), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    here = os.path.abspath(__file__)
    runs = []
    for root in args.roots:
        out = subprocess.run([sys.executable, here, "--one", root],
                             capture_output=True, text=True, timeout=900,
                             cwd=os.path.dirname(here))
        if out.returncode:
            raise RuntimeError(f"{root}: exit {out.returncode}\n"
                               f"{out.stdout[-3000:]}{out.stderr[-3000:]}")
        run = json.loads(next(line for line in out.stdout.splitlines()
                              if line.startswith("RESULT "))[7:])
        runs.append(run)
        print(f"{root}: MoE step median {run['step_ms']:.3f} ms (mean "
              f"{run['mean_ms']:.3f}) over {TIMED} steps; losses "
              f"{['%.4f' % x for x in run['losses']]}; peak "
              f"{run['peak_gib']:.2f} GiB; {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"smi": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
