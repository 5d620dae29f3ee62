"""Helpers of the tests/test_torch_bench_*.py files (not a test): run a
benchmark tool of either package in a process of its own, read its JSON,
and compare the shape of two result documents."""

import os
import subprocess
import sys
from pathlib import Path

from chip_smoke import last_json  # noqa: F401 - the tests' parser too

REPO = Path(__file__).resolve().parent.parent
# each tool process, and the workers its cluster starts, on a few threads:
# the tier-1 run puts several test files beside each other on the cores
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
           PYTHONPATH=str(REPO))


def start(argv, code=None):
    """Start `python argv...` (or `python -c code argv...`) from the repo
    root, stdout and stderr piped apart."""
    cmd = [sys.executable] + (["-c", code] if code else []) + list(argv)
    return subprocess.Popen(cmd, cwd=REPO, env=ENV, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish(proc, timeout):
    """(returncode, stdout, stderr) of a process started by start();
    killed at `timeout` seconds (returncode None then)."""
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        return None, out, err


def shape(doc):
    """The key structure of a JSON document: dicts by their keys, lists
    element by element, every other value None."""
    if isinstance(doc, dict):
        return {k: shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [shape(v) for v in doc]
    return None


def import_alone(module):
    """(returncode, output) of importing `module` alone in a fresh
    process that prints the jax, optax and ray_tpu modules it loaded."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            f"print('BAD', sorted(n for n in sys.modules if n.split('.')[0] "
            f"in ('jax', 'jaxlib', 'optax', 'orbax', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout + out.stderr
