"""The port's ownership fuzz harness (ray_tpu_torch/tools/
fuzz_ownership.py, the JAX package's tools/fuzz_ownership.py under the
rename rule) over the port's runtime, on the CPU.

tests/test_ownership_fuzz.py:237-245's three seeded cases, (101,
"delay", 50), (202, "drop", 50) and (303, "mixed", 40), each through
`python -m ray_tpu_torch.tools.fuzz_ownership --format=json` in a process
of its own under a timeout of its own (FUZZ_TIMEOUT_S), so that a hang
fails its case instead of holding the run. The three start together
when the module's first case runs. Each report: no invariant violated,
at least one check.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CASES = [(101, "delay", 50), (202, "drop", 50), (303, "mixed", 40)]
# each case alone takes 5-15 s on a 4-core box; a kill schedule's drain
# may wait up to 60 s
FUZZ_TIMEOUT_S = 180


@pytest.fixture(scope="module")
def fuzz_runs():
    procs = {}
    for seed, schedule, steps in CASES:
        procs[seed] = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.tools.fuzz_ownership",
             "--seed", str(seed), "--steps", str(steps), "--schedule",
             schedule, "--check-every", str(steps // 2),
             "--quiesce-timeout", "20", "--format=json"],
            cwd=REPO, text=True, env=dict(os.environ, PYTHONPATH=str(REPO)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("seed,schedule,steps", CASES)
def test_fuzz_smoke_in_a_process_of_its_own(fuzz_runs, seed, schedule,
                                            steps):
    proc = fuzz_runs[seed]
    try:
        out, _ = proc.communicate(timeout=FUZZ_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        pytest.fail(f"seed {seed} ({schedule}) hung past {FUZZ_TIMEOUT_S} "
                    f"s:\n{out[-3000:]}")
    reports = [line for line in out.splitlines() if line.startswith("{")]
    assert reports, out[-3000:]
    report = json.loads(reports[-1])
    assert (report["seed"], report["schedule"], report["steps"]) == \
        (seed, schedule, steps)
    assert report["ok"], "\n".join(report["violations"])
    assert report["checks"] >= 1
    assert proc.returncode == 0, out[-3000:]
