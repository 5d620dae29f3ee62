"""The port's replay-plane benchmark (ray_tpu_torch/tools/bench_replay.py,
the JAX package's tools/bench_replay.py under the rename rule with the
edits REPAIRED lists in test_torch_runtime.py) on the CPU.

Both tools run at `--seconds 1 --shards 1,2 --writers 1`, each in a
process of its own, started together when the module's first test runs.
The port's driver-buffer mode and both shard counts add and sample
(its clock starts once the writers and shards are up); it prints the
reference's keys.
"""

import pytest

from _torch_bench_procs import finish, import_alone, last_json, shape, start

ARGS = ["--seconds", "1", "--shards", "1,2", "--writers", "1",
        "--format", "json"]
TIMEOUT_S = 150


@pytest.fixture(scope="module")
def runs():
    procs = {"port": start(["-m", "ray_tpu_torch.tools.bench_replay"]
                           + ARGS),
             "reference": start(["tools/bench_replay.py"] + ARGS)}
    out = {}
    for side, proc in procs.items():
        rc, stdout, err = finish(proc, TIMEOUT_S)
        assert rc == 0, f"{side}: rc={rc}\n{stdout[-2000:]}\n{err[-3000:]}"
        out[side] = last_json(stdout)
    yield out


@pytest.mark.parametrize("mode", ["driver_buffer", "replay_shards_1",
                                  "replay_shards_2"])
def test_each_mode_adds_and_samples(runs, mode):
    row = runs["port"]["results"][mode]
    assert row["adds_per_sec"] > 0 and row["samples_per_sec"] > 0, row
    assert row["priority_updates_per_sec"] > 0, row
    if mode != "driver_buffer":
        assert row["rpc_counts"]["pushes"] > 0, row
        assert row["unmatched_priority_updates"] == 0, row


def test_keys_equal_the_reference(runs):
    port, ref = runs["port"], runs["reference"]
    assert port["suite"] == ref["suite"] == "replay_throughput"
    assert shape(port) == shape(ref)


def test_imports_alone_without_jax():
    rc, out = import_alone("ray_tpu_torch.tools.bench_replay")
    assert rc == 0 and "BAD []" in out, out
