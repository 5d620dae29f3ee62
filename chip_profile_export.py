#!/usr/bin/env python3
"""How long `util.state.profile(device=True)` takes to answer beyond its
window, by window length, on one NVIDIA H100.

    python3 chip_profile_export.py [--out FILE]

Starts a one-node cluster and an actor that holds the card and trains
GPT-2-125M in a loop (chip_smoke.py phase "tooling"'s StepLoop: the
slice's width, batch 16 x 1,024), then captures it through the cluster
once for each of WINDOWS, in order. For each: the seconds until the
capture answered, those beyond the window (what the collect's deadlines
must leave a device trace: profiler.device_export_s), the trace file's
size, its forward-kernel launches and the steps the actor ran. Prints
one JSON object with the card's name and power limit, and exits non-zero
without a card or when a capture came back without the actor's trace.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import chip_smoke

WINDOWS = (2.0, 10.0, 30.0)   # seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_profile_export: no CUDA device", file=sys.stderr)
        return 2
    import ray_tpu_torch
    from ray_tpu_torch._device import gpu_info
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.util import gpu_profiler
    from ray_tpu_torch.util import state as state_api

    kind, smi = torch.cuda.get_device_name(0), gpu_info()
    _build.build()   # the actor's process reuses the libraries
    cfg = chip_smoke.slice_config()
    tokens = np.random.default_rng(chip_smoke.SEED).integers(
        0, cfg.vocab_size, (chip_smoke.BATCH, cfg.max_seq_len + 1))
    root = tempfile.mkdtemp(prefix="chip_profile_export_")
    result = {"device": kind, "nvidia_smi": smi, "captures": []}
    ok = True
    try:
        ray_tpu_torch.init(num_cpus=2, _session_root=root)
        looper = ray_tpu_torch.remote(num_gpus=1)(
            chip_smoke.StepLoop).remote(tokens)
        info = ray_tpu_torch.get(looper.info.remote(), timeout=300)
        deadline = time.perf_counter() + 300
        while info["steps"] < 3:
            if info["error"] or time.perf_counter() > deadline:
                raise AssertionError(f"the actor's loop stalled: {info}")
            time.sleep(0.5)
            info = ray_tpu_torch.get(looper.info.remote(), timeout=60)
        for window in WINDOWS:
            steps0 = ray_tpu_torch.get(looper.info.remote())["steps"]
            t0 = time.perf_counter()
            out = state_api.profile(duration=window, device=True)
            answer_s = time.perf_counter() - t0
            steps = ray_tpu_torch.get(looper.info.remote())["steps"] - steps0
            mine = [p for p in out["profiles"] if p["pid"] == info["pid"]]
            record = {"window_s": window, "answer_s": answer_s,
                      "beyond_window_s": answer_s - window,
                      "steps": steps, "trace_mb": None, "fwd_launches": 0}
            run = (gpu_profiler.latest_trace_dir(mine[0]["xplane_dir"])
                   if mine and "xplane_dir" in mine[0] else None)
            if run:
                record["trace_mb"] = os.path.getsize(
                    gpu_profiler._trace_file(run)) / 2**20
                record["fwd_launches"] = sum(
                    r["count"] for k, r in
                    gpu_profiler.summary(run)["kernels"].items()
                    if chip_smoke.traced_as(k, "flash_fwd"))
            else:
                record["entry"] = mine[0] if mine else None
                ok = False
            for p in out["profiles"]:
                if p.get("xplane_dir"):
                    shutil.rmtree(p["xplane_dir"], ignore_errors=True)
            result["captures"].append(record)
            print(f"window {window:g} s: answered in {answer_s:.2f} s "
                  f"({answer_s - window:.2f} s beyond it), trace "
                  f"{record['trace_mb']} MiB, {record['fwd_launches']} "
                  f"forward launches, {steps} steps; {kind}; {smi}",
                  flush=True)
        ray_tpu_torch.get(looper.stop.remote(), timeout=120)
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
