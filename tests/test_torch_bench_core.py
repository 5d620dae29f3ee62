"""The port's core-runtime microbenchmark (ray_tpu_torch/tools/
bench_core.py, the JAX package's tools/bench_core.py under the rename
rule; test_torch_runtime.py holds the copy) on the CPU.

`python -m ray_tpu_torch.tools.bench_core --n 150 --skip-dag` holds the
floors of the reference's tier-1 smoke (tests/test_bench_smoke.py,
imported as it is) and prints the suite and result keys the reference
tool prints at the same arguments; a floor it misses exits 1. The
three processes start together when the module's first test runs.
chip_tools.py, which runs all six tools on a card, exits non-zero
without one, and alone.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

from _torch_bench_procs import (REPO, finish, import_alone, last_json,
                                start)

ARGS = ["--n", "150", "--format", "json", "--skip-dag"]
TIMEOUT_S = 150


def _smoke_floors():
    spec = importlib.util.spec_from_file_location(
        "_bench_smoke_floors", REPO / "tests" / "test_bench_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._FLOORS


FLOORS = _smoke_floors()


@pytest.fixture(scope="module")
def runs():
    floors = [a for name, value in FLOORS.items()
              for a in ("--floor", f"{name}={value}")]
    procs = {
        "port": start(["-m", "ray_tpu_torch.tools.bench_core"] + ARGS
                      + floors),
        "reference": start(["tools/bench_core.py"] + ARGS),
        # a floor no run reaches: the gate's exit
        "miss": start(["-m", "ray_tpu_torch.tools.bench_core", "--n", "20",
                       "--format", "json", "--skip-dag", "--floor",
                       "tasks_per_sec=1e12"]),
    }
    yield {k: finish(p, TIMEOUT_S) for k, p in procs.items()}


def test_port_holds_the_reference_smoke_floors(runs):
    rc, out, err = runs["port"]
    assert rc == 0, f"rc={rc}\n{out[-3000:]}\n{err[-3000:]}"
    results = last_json(out)["results"]
    for name, floor in FLOORS.items():
        assert results[name]["value"] >= floor, (name, results[name])


def test_suite_and_keys_equal_the_reference(runs):
    docs = {}
    for side in ("port", "reference"):
        rc, out, err = runs[side]
        assert rc == 0, f"{side}: rc={rc}\n{err[-3000:]}"
        docs[side] = last_json(out)
    port, ref = docs["port"], docs["reference"]
    assert port["suite"] == ref["suite"] == "core_microbenchmark"
    assert sorted(port) == sorted(ref)
    assert sorted(port["results"]) == sorted(ref["results"])
    for name, row in port["results"].items():
        assert sorted(row) == sorted(ref["results"][name]), name


def test_a_missed_floor_exits_nonzero(runs):
    rc, out, err = runs["miss"]
    assert rc == 1, f"rc={rc}\n{err[-3000:]}"
    assert "FLOOR MISS: tasks_per_sec" in err
    assert last_json(out)["suite"] == "core_microbenchmark"


def test_chip_tools_fails_without_cuda_and_alone(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_tools.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert '"ok": true' not in out.stdout
    shutil.copy(REPO / "chip_tools.py", tmp_path / "chip_tools.py")
    alone = subprocess.run([sys.executable, "chip_tools.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120,
                           env=dict(env, PYTHONPATH=""))
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout


def test_imports_alone_without_jax():
    rc, out = import_alone("ray_tpu_torch.tools.bench_core")
    assert rc == 0 and "BAD []" in out, out
