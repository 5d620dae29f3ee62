"""The port's object-transport benchmark (ray_tpu_torch/tools/
transport_bench.py, the JAX package's tools/transport_bench.py under the
rename rule; test_torch_runtime.py holds the copy) on the CPU, against
the reference tool over the JAX package's runtime.

Each package's tool runs its multi-get, fragment-ship and span-overhead
benches in a process of its own (RUN, with its HostStage's staged bytes
recorded), and its whole CLI in another; the four processes start
together when the module's first test runs. A batched get takes one
store RPC in both; the fragment ship stages the same bytes; a 1 MiB
put+get records the reference's spans, in its order, on the calling
thread (but for the get's own span, which both record only when the get
took 1 ms or more); the CLI prints the reference's result keys. No test holds a
time. (The tool's records per op count the ring's records from every
thread of the process during the op: under load a background thread's
record can land in the window, so that figure is held above 0 only.)
"""

import pytest

from _torch_bench_procs import finish, import_alone, last_json, start

PACKAGES = {"port": ("ray_tpu_torch", "ray_tpu_torch.tools.transport_bench"),
            "reference": ("ray_tpu", "tools.transport_bench")}
CLI = {"port": ["-m", "ray_tpu_torch.tools.transport_bench"],
       "reference": ["tools/transport_bench.py"]}
TIMEOUT_S = 150

RUN = r"""
import importlib, json, sys, threading
import numpy as np
pkg = importlib.import_module(sys.argv[1])
tb = importlib.import_module(sys.argv[2])
feed = importlib.import_module(sys.argv[1] + ".rllib.utils.device_feed")
staged = []
assemble = feed.HostStage.assemble

def recording(self, frags, axis_for):
    sb = assemble(self, frags, axis_for)
    staged.append(sb.nbytes)
    return sb

feed.HostStage.assemble = recording
pkg.init(num_cpus=2, object_store_memory=256 << 20)
results = {}
tb.bench_multi_get(results)
tb.bench_fragment_ship(results)
tb.bench_spans_overhead(results, reps=8, warm=False, probes=30)
# the spans one 1 MiB put+get records on this thread, op by op
spans = importlib.import_module(sys.argv[1] + "._private.spans")
w = pkg._private.worker.global_worker()
arr = np.random.default_rng(0).integers(0, 255, size=1 << 20, dtype=np.uint8)
spans.configure(enabled=True)
tid = threading.get_ident()
own = []
for _ in range(8):
    spans.ring().clear()
    ref = pkg.put(arr)
    pkg.get(ref)
    w.core_worker.free([ref])
    del ref
    own.append([r[1] for r in spans.ring().snapshot_records()
                if r[4] == tid])
pkg.shutdown()
print(json.dumps({"results": results, "staged": sorted(set(staged)),
                  "own_spans": own}))
"""


@pytest.fixture(scope="module")
def runs():
    procs = {}
    for side, (pkg, tool) in PACKAGES.items():
        procs[side] = start([pkg, tool], code=RUN)
        procs[side + "_cli"] = start(CLI[side] + ["--format", "json"])
    out = {}
    for name, proc in procs.items():
        rc, stdout, err = finish(proc, TIMEOUT_S)
        assert rc == 0, f"{name}: rc={rc}\n{stdout[-2000:]}\n{err[-3000:]}"
        out[name] = last_json(stdout)
    yield out


@pytest.mark.parametrize("side", list(PACKAGES))
def test_a_batched_get_takes_one_store_rpc(runs, side):
    assert runs[side]["results"]["multi_get_store_rpcs"] == 1
    assert runs[side + "_cli"]["results"]["multi_get_store_rpcs"] == 1


def test_the_fragment_ship_stages_the_reference_bytes(runs):
    port, ref = runs["port"]["staged"], runs["reference"]["staged"]
    # 8 fragments of [50, 8] steps: obs f32 [50, 8, 4, 16], actions i32,
    # rewards and behaviour_logp f32, dones bool, bootstrap_value f32 [8]
    assert port == ref == [8 * (50 * 8 * (4 * 16 * 4 + 4 + 4 + 1 + 4)
                                + 8 * 4)]


# recorded only for a get of several refs or one that took 1 ms or more
# (_private/core_worker.py, CoreWorker.get, in both packages)
TIMED_SPANS = {"cw.get"}


def test_put_get_records_the_reference_spans(runs):
    port, ref = ([[n for n in op if n not in TIMED_SPANS] for op in
                  runs[side]["own_spans"]] for side in PACKAGES)
    assert port == ref and all(port), (runs["port"]["own_spans"],
                                       runs["reference"]["own_spans"])
    for side in PACKAGES:
        assert runs[side]["results"]["spans_records_per_op"] > 0


def test_cli_result_keys_equal_the_reference(runs):
    port, ref = runs["port_cli"], runs["reference_cli"]
    assert port["suite"] == ref["suite"] == "object_transport"
    assert sorted(port["results"]) == sorted(ref["results"])


def test_imports_alone_without_jax():
    rc, out = import_alone("ray_tpu_torch.tools.transport_bench")
    assert rc == 0 and "BAD []" in out, out
