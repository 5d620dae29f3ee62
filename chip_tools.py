#!/usr/bin/env python3
"""The port's six measurement tools on one NVIDIA H100, at their defaults.

    python3 chip_tools.py [--out FILE]   # from the repo root

Builds the flash-attention kernels, then runs each tool of
ray_tpu_torch/tools/ as a user runs it, one after the other, each in a
process of its own (TOOLS: its arguments and time limit):
  bench_core       2,000 ops a suite, the compiled-DAG suite;
  transport_bench  put/get by size, the batched get, the fragment ship,
                   the span recorder's cost;
  bench_replay     the driver buffer against 1, 2 and 4 shards, 8 s each;
  bench_serve      the handle path, the HTTP closed loop, the brownout;
  bench_rl         PPO CartPole and IMPALA MiniPong, 60 s each, the
                   learners on the card (--seconds 60);
  bench_ablate     every variant of the GPT-2-125M train step on the card;
  lease            bench_ablate --suite lease (1,500 tasks a variant).
Each tool's output is copied as it comes, its lines marked "NAME|". Then
one JSON object of each tool's document (bench_ablate's and lease's rows
parsed), the card's name and power limit as nvidia-smi prints them, and
last {"ok": true, "device": {...}}. Exits non-zero without a CUDA card,
and when any tool fails or runs past its limit (its stderr's tail
printed); the other tools run all the same.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

from chip_smoke import last_json

REPO = os.path.dirname(os.path.abspath(__file__))
# (name, argv after `python -m`, time limit s)
TOOLS = (
    ("bench_core", ["ray_tpu_torch.tools.bench_core", "--format", "json"],
     300),
    ("transport_bench", ["ray_tpu_torch.tools.transport_bench",
                         "--format", "json"], 300),
    ("bench_replay", ["ray_tpu_torch.tools.bench_replay", "--format", "json"],
     300),
    ("bench_serve", ["ray_tpu_torch.tools.bench_serve"], 400),
    ("bench_rl", ["ray_tpu_torch.tools.bench_rl", "--seconds", "60"], 600),
    ("bench_ablate", ["ray_tpu_torch.tools.bench_ablate"], 600),
    ("lease", ["ray_tpu_torch.tools.bench_ablate", "--suite", "lease"], 300),
)
ABLATE_ROW = re.compile(r"^(\S+)\s+step=\s*([\d.]+)ms tok/s=\s*(\d+) "
                        r"tflops=\s*([\d.]+) loss=([-\d.naif]+)$")
LEASE_ROW = re.compile(r"^(\S+)\s+([\d,]+) tasks/s \(([\d.]+)s / (\d+)\)$")


def parse(name, out):
    """A tool's result: its JSON document, or bench_ablate's (and the
    lease suite's) rows by name."""
    if name == "bench_ablate":
        rows = {}
        for line in out.splitlines():
            m = ABLATE_ROW.match(line.strip())
            if m:
                rows[m[1]] = {"step_ms": float(m[2]),
                              "tokens_per_sec": int(m[3]),
                              "tflops": float(m[4]), "loss": float(m[5])}
        return rows
    if name == "lease":
        return {m[1]: {"tasks_per_sec": int(m[2].replace(",", "")),
                       "seconds": float(m[3]), "n": int(m[4])}
                for m in map(LEASE_ROW.match, map(str.strip,
                                                  out.splitlines())) if m}
    return last_json(out)


def run(name, argv, limit):
    """Runs one tool; (returncode or None past its limit, stdout, the tail
    of stderr, seconds). Copies stdout line by line as it comes."""
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=REPO,
                                text=True, stdout=subprocess.PIPE,
                                stderr=err)
        lines = []

        def copy():
            for line in proc.stdout:
                lines.append(line)
                sys.stdout.write(f"{name}| {line}")
                sys.stdout.flush()

        copier = threading.Thread(target=copy, daemon=True)
        copier.start()
        try:
            rc = proc.wait(timeout=limit)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
        copier.join(timeout=30)
        err.seek(0)
        tail = err.read()[-4000:]
    return rc, "".join(lines), tail, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results' JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_tools: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch._device import gpu_info
    from ray_tpu_torch.ops import _build

    kind, smi = torch.cuda.get_device_name(0), gpu_info()
    print(f"{kind}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build()   # the tools' processes reuse the libraries
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    results, failed = {"device": kind, "nvidia_smi": smi, "tools": {}}, []
    for name, tool_argv, limit in TOOLS:
        print(f"[{name}] ...", flush=True)
        rc, out, tail, seconds = run(name, tool_argv, limit)
        entry = {"argv": tool_argv, "seconds": round(seconds, 1),
                 "returncode": rc}
        try:
            entry["result"] = parse(name, out) if rc == 0 else None
        except (ValueError, json.JSONDecodeError) as e:
            rc = entry["returncode"] = f"unparsed: {e}"
        if name in ("bench_ablate", "lease") and rc == 0 and \
                not entry["result"]:
            rc = entry["returncode"] = "no rows"
        results["tools"][name] = entry
        if rc != 0:
            failed.append(name)
            print(f"[{name}] FAILED ({rc}) after {seconds:.1f} s; stderr's "
                  f"tail:\n{tail}", flush=True)
        else:
            print(f"[{name}] ok ({seconds:.1f} s)", flush=True)
    line = json.dumps(results)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if failed:
        print(f"chip_tools: failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
