"""The port's Serve load harness (ray_tpu_torch/tools/bench_serve.py, the
JAX package's tools/bench_serve.py under the rename rule; test_torch_
runtime.py holds the copy) on the CPU.

_percentiles equals the reference's on the same samples. Both tools run
one short stage of each kind (the handle path, one closed-loop HTTP
stage of 4 clients over the @serve.batch echo, the brownout at 3x the
measured saturation with 8 clients), each in a process of its own,
started together when the module's first test runs: the port's stages
answer, and its document has the reference's keys.
"""

import importlib.util

import numpy as np
import pytest

from _torch_bench_procs import (REPO, finish, import_alone, last_json,
                                shape, start)
from ray_tpu_torch.tools import bench_serve

ARGS = ["--seconds", "1", "--sweep", "4", "--overload", "3",
        "--workers", "8"]
TIMEOUT_S = 150


def _reference():
    spec = importlib.util.spec_from_file_location(
        "_reference_bench_serve", REPO / "tools" / "bench_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SAMPLES = {"empty": [], "one": [0.004],
           "uniform": list(np.random.default_rng(0).uniform(0, 0.05, 997)),
           "tail": list(np.random.default_rng(1).lognormal(-5, 1, 64))}


@pytest.mark.parametrize("name", list(SAMPLES))
def test_percentiles_equal_the_reference(name):
    ref = _reference()
    for points in ((50, 95, 99), (1, 50, 100)):
        assert bench_serve._percentiles(SAMPLES[name], points) == \
            ref._percentiles(SAMPLES[name], points)


@pytest.fixture(scope="module")
def runs():
    procs = {"port": start(["-m", "ray_tpu_torch.tools.bench_serve"]
                           + ARGS),
             "reference": start(["tools/bench_serve.py"] + ARGS)}
    out = {}
    for side, proc in procs.items():
        rc, stdout, err = finish(proc, TIMEOUT_S)
        assert rc == 0, f"{side}: rc={rc}\n{stdout[-2000:]}\n{err[-3000:]}"
        out[side] = last_json(stdout)
    yield out


def test_handle_and_closed_loop_stage_answer(runs):
    doc = runs["port"]
    assert doc["handle"]["requests"] > 0 and doc["handle"]["errors"] == 0
    (stage,) = doc["http_proxy"]["sweep"]
    assert stage["workers"] == 4 and stage["requests_ok"] > 0, stage
    assert stage["errors"] == 0, stage


def test_brownout_factor_answers(runs):
    brownout = runs["port"]["brownout"]
    (level,) = brownout["levels"]
    assert level["factor"] == 3.0 and level["goodput_rps"] > 0, level
    assert level["retry_after_on_all_sheds"], level
    assert brownout["saturation_rps"] > 0, brownout


def test_keys_equal_the_reference(runs):
    port, ref = runs["port"], runs["reference"]
    assert port["suite"] == ref["suite"] == "serve_fleet_throughput"
    assert shape(port) == shape(ref)


def test_imports_alone_without_jax():
    rc, out = import_alone("ray_tpu_torch.tools.bench_serve")
    assert rc == 0 and "BAD []" in out, out
