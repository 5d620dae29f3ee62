"""Ablation harness for the headline bench: times train-step variants
to localize non-matmul overhead. A development tool.

Usage: python -m ray_tpu_torch.tools.bench_ablate [name ...]
       python -m ray_tpu_torch.tools.bench_ablate --suite lease [--n 1500]
           [--merge FILE]

The variants train GPT-2-125M (the headline bench's config) on the
card through the port's make_train_step; run_variant's `device` and
`base` run one on another device and a narrower config (the CPU tests
pass both). scan_unroll is a knob of the JAX package's compiler: the
port's config keeps the field and ignores it, so best_unroll1 times the
same step as best. The process exits non-zero when any variant (or
lease row) fails.

`--suite lease` ablates the task-path lease transport (ROADMAP item
1): serialized lease requests (MAX_PENDING_LEASE_REQUESTS=1), the r05
pipelined default (=4), and the batched control plane (async lease
requester + multi-grant nm_lease_request_batch). Each variant runs in
a fresh subprocess — the flags are read at init. `--merge` writes the
table under "ablations"/"lease" of an existing bench JSON.
"""

from __future__ import annotations

import os
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _REPO_ROOT)

BATCH = 16
WARMUP = 3
STEPS = 10
FLOPS_PER_TOKEN = 968e6
# the GPT-2 tokenizer's vocabulary, from which the tokens are drawn (the
# config pads it to 50304)
VOCAB = 50257


def run_variant(name: str, *, n_heads=6, loss_chunk=0, batch=BATCH,
                no_head=False, attention_impl="auto", scan_unroll=12,
                remat=False, sgd=False, no_attn=False, device=None,
                base=None) -> dict:
    """Time STEPS train steps of the variant after WARMUP ones on
    `device` (None: the card, raising where there is none), GPT2_125M
    or `base` with the variant's knobs; prints the row and returns its
    step_ms, tokens_per_sec, the final loss and the steps run."""
    import torch

    import ray_tpu_torch.models.transformer as tr
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.models import GPT2_125M, Transformer
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step

    dev = resolve_device(device)
    cfg = (base or GPT2_125M).replace(
        n_heads=n_heads, remat=remat, remat_policy="dots",
        attention_impl=attention_impl, scan_unroll=scan_unroll,
        loss_chunk=loss_chunk)
    restore_attn = None
    try:
        if no_attn:
            # identity attention: measures the whole attention block's
            # cost; the hook is read at every forward
            restore_attn = tr._attention_fn
            tr._attention_fn = lambda impl, mesh: (
                lambda q, k, v, scale: q)
        model = Transformer(cfg, device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, min(VOCAB, cfg.vocab_size),
                               (batch, cfg.max_seq_len + 1),
                               generator=gen, device=dev)
        if no_head:
            def loss_fn(p, b):
                h = model.hidden(b["tokens"][:, :-1])
                return torch.mean(torch.square(h.float()))
        else:
            def loss_fn(p, b):
                return model.loss(b)

        # optax.sgd(1e-4): plain SGD, no momentum
        opt = (lambda params: torch.optim.SGD(params, lr=1e-4)) if sgd \
            else adamw(1e-4, weight_decay=0.01)
        init_state, train_step = make_train_step(loss_fn, optimizer=opt,
                                                 device=dev)
        state = init_state(dict(model.named_parameters()))
        batch_d = {"tokens": tokens}
        for _ in range(WARMUP):
            state, metrics = train_step(state, batch_d)
        if WARMUP:
            metrics["loss"].item()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, metrics = train_step(state, batch_d)
        loss = float(metrics["loss"].item())
        dt = (time.perf_counter() - t0) / STEPS
        del state, model
    finally:
        if restore_attn is not None:
            tr._attention_fn = restore_attn
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    toks = batch * cfg.max_seq_len
    tps = toks / dt
    print(f"{name:28s} step={dt*1e3:7.1f}ms tok/s={tps:9.0f} "
          f"tflops={tps*FLOPS_PER_TOKEN/1e12:6.1f} loss={loss:.4f}",
          flush=True)
    return {"step_ms": dt * 1e3, "tokens_per_sec": tps, "loss": loss,
            "steps": WARMUP + STEPS}


# NOTE: run_variant's defaults ARE the shipping bench config (heads6 +
# unchunked CE). Legacy round-3/4a variants pin every divergent knob
# explicitly so their meaning never drifts when defaults move.
VARIANTS = {
    "r3_baseline": {"n_heads": 12, "loss_chunk": 256},
    "r3_heads6": {"n_heads": 6, "loss_chunk": 256},
    "r3_chunk512": {"n_heads": 12, "loss_chunk": 512},
    "heads6_chunk512": {"n_heads": 6, "loss_chunk": 512},
    "nohead": {"no_head": True, "n_heads": 12, "loss_chunk": 256},
    "nohead_heads6": {"no_head": True, "n_heads": 6, "loss_chunk": 256},
    "r3_dense": {"n_heads": 12, "loss_chunk": 256,
                 "attention_impl": "dense"},
    "heads6_b32_c512": {"n_heads": 6, "batch": 32, "loss_chunk": 512},
    "heads6_dense_c512": {"n_heads": 6, "attention_impl": "dense",
                          "loss_chunk": 512},
    # round-4b: decompose the ~40% non-matmul time around the shipping
    # config ("best" = the defaults)
    "best": {},
    "best_sgd": {"sgd": True},
    "best_noattn": {"no_attn": True},
    "best_dense": {"attention_impl": "dense"},
    "best_b24": {"batch": 24},
    "best_unroll1": {"scan_unroll": 1},
}


# ----------------------------------------------------------------------
# --suite lease: task-path lease-transport ablation
# ----------------------------------------------------------------------

_LEASE_RUNNER = r"""
import json, sys, time
import ray_tpu_torch
from ray_tpu_torch._private.core_worker import CoreWorker
CoreWorker.MAX_PENDING_LEASE_REQUESTS = int(sys.argv[1])
n = int(sys.argv[2])
ray_tpu_torch.init(num_cpus=4)

@ray_tpu_torch.remote
def tiny():
    return b"ok"

ray_tpu_torch.get([tiny.remote() for _ in range(n)])  # warm the worker pool
t0 = time.perf_counter()
ray_tpu_torch.get([tiny.remote() for _ in range(n)])
dt = time.perf_counter() - t0
print("RESULT " + json.dumps(
    {"tasks_per_sec": round(n / dt, 1), "seconds": round(dt, 3)}))
ray_tpu_torch.shutdown()
"""

# (name, RAY_TPU_TASK_LEASE_BATCHING, MAX_PENDING_LEASE_REQUESTS)
LEASE_VARIANTS = [
    ("pending1", "0", 1),   # serialized: one lease round trip at a time
    ("pending4", "0", 4),   # r05 default: pipelined singleton requests
    ("batched", "1", 4),    # async requester + multi-grant batch RPCs
]


def run_lease_suite(n: int, merge_path: str) -> int:
    """The three rows; returns how many failed."""
    import json
    import subprocess

    table = {}
    for name, batching, pending in LEASE_VARIANTS:
        env = dict(os.environ,
                   RAY_TPU_TASK_LEASE_BATCHING=batching)
        proc = subprocess.run(
            [sys.executable, "-c", _LEASE_RUNNER, str(pending), str(n)],
            env=env, capture_output=True, text=True, timeout=600,
            cwd=_REPO_ROOT)
        row = None
        for line in proc.stdout.splitlines():
            if line.startswith("RESULT "):
                row = json.loads(line[len("RESULT "):])
        if row is None:
            print(f"{name:10s} FAILED rc={proc.returncode}\n"
                  f"{proc.stderr[-2000:]}", flush=True)
            continue
        table[name] = row
        print(f"{name:10s} {row['tasks_per_sec']:>9,.0f} tasks/s "
              f"({row['seconds']:.3f}s / {n})", flush=True)
    if merge_path:
        with open(merge_path, encoding="utf-8") as f:
            doc = json.load(f)
        doc.setdefault("ablations", {})["lease"] = {
            "ops": n, "variants": table}
        with open(merge_path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        print(f"merged into {merge_path}", flush=True)
    return len(LEASE_VARIANTS) - len(table)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--suite" in argv:
        i = argv.index("--suite")
        suite = argv[i + 1]
        if suite != "lease":
            raise SystemExit(f"unknown suite: {suite}")
        n = int(argv[argv.index("--n") + 1]) if "--n" in argv else 1500
        merge = argv[argv.index("--merge") + 1] if "--merge" in argv \
            else ""
        return 1 if run_lease_suite(n, merge) else 0
    names = argv or list(VARIANTS)
    failed = 0
    for n in names:
        try:
            run_variant(n, **VARIANTS[n])
        except Exception as e:  # noqa: BLE001
            print(f"{n:28s} FAILED: {type(e).__name__}: {e}", flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
