"""Core-runtime microbenchmarks -> BENCH_CORE_r{N}.json.

reference parity: python/ray/_private/ray_perf.py:93-241 (the `ray
microbenchmark` suites: task throughput, sync/async actor calls,
put/get throughput, wait over many refs) and the single-node rows of
release/benchmarks/README.md:27-31. Numbers are machine-dependent:
keep them beside the machine they were taken on.

Usage: python -m ray_tpu_torch.tools.bench_core [--out FILE]
           [--n 2000] [--format json] [--floor NAME=VALUE ...]

--floor turns the run into a regression gate: after measuring, each
NAME (a results key) is asserted >= VALUE and the process exits
non-zero listing every miss. tests/test_torch_bench_core.py wires this as a
tier-1 smoke with tiny op counts and floors far below the recorded
baseline — it catches order-of-magnitude breakage (a serialized lease
path, a dead fast path), not CI-box noise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--n", type=int, default=2000,
                    help="ops per throughput suite")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="json: print the result document to stdout")
    ap.add_argument("--floor", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="fail (exit 1) if results[NAME].value < VALUE; "
                         "repeatable")
    ap.add_argument("--skip-dag", action="store_true",
                    help="skip the compiled-DAG suite (it spawns "
                         "several actor workers)")
    args = ap.parse_args()

    floors = []
    for spec in args.floor:
        name, _, val = spec.partition("=")
        floors.append((name, float(val)))

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._private import goodput

    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    results = {}
    quiet = args.format == "json"
    # ledger for this bench process: measured suite runs are productive,
    # warmups/setup read as idle — the goodput block in the JSON shows
    # how much of the bench wall actually measured something
    goodput.ledger("bench_core").bind()

    def timed(name, fn, ops, unit="ops/s"):
        fn()  # warm (workers spawned, code paths jitted)
        t0 = time.perf_counter()
        with goodput.bucket(goodput.PRODUCTIVE):
            fn()
        dt = time.perf_counter() - t0
        results[name] = {"value": round(ops / dt, 1), "unit": unit,
                         "ops": ops, "seconds": round(dt, 3)}
        if not quiet:
            print(f"{name}: {ops / dt:,.0f} {unit}", flush=True)

    n = args.n

    @ray_tpu_torch.remote
    def tiny():
        return b"ok"

    timed("tasks_per_sec",
          lambda: ray_tpu_torch.get([tiny.remote() for _ in range(n)]), n)

    @ray_tpu_torch.remote
    class Sync:
        def m(self):
            return b"ok"

    a = Sync.options(num_cpus=0.05).remote()
    timed("sync_actor_calls_per_sec",
          lambda: ray_tpu_torch.get([a.m.remote() for _ in range(n)]), n)

    @ray_tpu_torch.remote
    class Async:
        async def m(self):
            return b"ok"

    b = Async.options(num_cpus=0.05).remote()
    timed("async_actor_calls_per_sec",
          lambda: ray_tpu_torch.get([b.m.remote() for _ in range(n)]), n)

    arr = np.zeros(1 << 20, dtype=np.uint8)  # 1 MiB
    m = max(10, n // 10)
    timed("put_1mib_mb_per_sec",
          lambda: [ray_tpu_torch.put(arr) for _ in range(m)], m, unit="MB/s")
    refs = [ray_tpu_torch.put(arr) for _ in range(m)]
    timed("get_1mib_mb_per_sec",
          lambda: ray_tpu_torch.get(refs), m, unit="MB/s")

    wait_refs = [ray_tpu_torch.put(np.int64(i)) for i in range(1000)]
    timed("wait_1k_refs_per_sec",
          lambda: ray_tpu_torch.wait(wait_refs, num_returns=1000,
                               timeout=60.0), 1000)

    if not args.skip_dag:
        # compiled vs interpreted DAG repeat-execution: the interpreted
        # walk instantiates a FRESH actor per execute; the compiled
        # plan reuses it, so the ratio is dominated by actor-creation
        # round trips it skips (acceptance: >= 3x)
        from ray_tpu_torch.dag import InputNode

        @ray_tpu_torch.remote
        class _Stage:
            def apply(self, x):
                return x + 1

        with InputNode() as inp:
            dag = _Stage.bind().apply.bind(inp)
        reps = 5

        def run_interpreted():
            for i in range(reps):
                # serial on purpose: the suite measures per-execute
                # round-trip latency, not pipelined throughput
                ray_tpu_torch.get(dag.execute(i))  # graftlint: disable=RT002

        run_interpreted()  # warm worker pool
        t0 = time.perf_counter()
        with goodput.bucket(goodput.PRODUCTIVE):
            run_interpreted()
        dt_interp = (time.perf_counter() - t0) / reps
        comp = dag.experimental_compile()
        ray_tpu_torch.get(comp.execute(0))  # warm the compiled channel
        t0 = time.perf_counter()
        with goodput.bucket(goodput.PRODUCTIVE):
            for i in range(reps):
                ray_tpu_torch.get(comp.execute(i))  # graftlint: disable=RT002
        dt_comp = (time.perf_counter() - t0) / reps
        comp.teardown()
        results["dag_compiled_speedup_x"] = {
            "value": round(dt_interp / dt_comp, 1), "unit": "x",
            "interpreted_ms": round(dt_interp * 1e3, 2),
            "compiled_ms": round(dt_comp * 1e3, 2)}
        if not quiet:
            print(f"dag_compiled_speedup_x: {dt_interp / dt_comp:.1f}x "
                  f"({dt_interp*1e3:.1f}ms -> {dt_comp*1e3:.1f}ms)",
                  flush=True)

    out = {
        "suite": "core_microbenchmark",
        "host": {"cpus": os.cpu_count()},
        "results": results,
        "goodput": goodput.summary().get("bench_core"),
    }
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
        if not quiet:
            print(f"wrote {args.out}")
    if quiet:
        print(json.dumps(out, indent=1))
    ray_tpu_torch.shutdown()

    misses = [(name, floor, results[name]["value"])
              for name, floor in floors
              if results[name]["value"] < floor]
    for name, floor, got in misses:
        print(f"FLOOR MISS: {name} = {got} < {floor}", file=sys.stderr,
              flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
