"""The port's deterministic examples print what the JAX package's print:
core_tasks_actors (tasks, objects, actors with a concurrency group,
placement groups), serve_inference (a batched deployment) and
serve_streaming_multiplex (a streamed generator, multiplexed models).
Each pair runs as two processes at once (run_pair, which
test_torch_examples_data_mesh.py uses too): the reference as
examples/README.md says (JAX_PLATFORMS=cpu, 8 virtual CPU devices, the
repo root on PYTHONPATH), the port as ``python -m
ray_tpu_torch.examples.<name>``. Every line must match, numbers to 1e-5
relative."""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=str(REPO) + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def run_pair(name, timeout=120):
    """(the reference script's stdout lines, the port's), both run to
    their end at the same time; either exiting non-zero fails."""
    procs = [subprocess.Popen(cmd, cwd=REPO, env=_env(), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in ([sys.executable, f"examples/{name}.py"],
                         [sys.executable, "-m",
                          f"ray_tpu_torch.examples.{name}"])]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, (p.args, err[-3000:])
            outs.append(out.splitlines())
    finally:
        for p in procs:
            p.kill()
    return outs


def assert_same_values(ref, port, rtol=1e-5):
    """Each line the same text, each number in it equal to 1e-5
    relative."""
    assert len(ref) == len(port), (ref, port)
    for a, b in zip(ref, port):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (a, b)
        for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
            assert math.isclose(float(x), float(y), rel_tol=rtol), (a, b)


@pytest.mark.parametrize("name", ["core_tasks_actors", "serve_inference",
                                  "serve_streaming_multiplex"])
def test_example_prints_what_the_reference_prints(name):
    ref, port = run_pair(name)
    assert ref, "the reference printed nothing"
    assert_same_values(ref, port)
