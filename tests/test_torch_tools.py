"""The port's perf_report (ray_tpu_torch/tools/perf_report.py, the JAX
package's tools/perf_report.py under the rename rule with the edits
REPAIRED lists in test_torch_runtime.py, which holds the copy) on the
CPU. test_torch_tools_lint.py and test_torch_fuzz_ownership.py hold the
other two tools.

- perf_report: a spans trace of a CPU IMPALA CartPole run of the port
  (2 runner actors, the learner thread local on the CPU, a few
  iterations), written by ray_tpu_torch.timeline(spans=True) and
  reported by the JAX package's tools/perf_report.py and by
  `python -m ray_tpu_torch.tools.perf_report`: the same JSON, every
  bucket of the learner thread's window, learner_compute above 0.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch.rllib import ImpalaConfig

REPO = Path(__file__).resolve().parent.parent
ITERATIONS = 15


@pytest.fixture(scope="module")
def impala_trace(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "impala_spans.json"
    ray_tpu_torch.init(num_cpus=3)
    try:
        algo = (ImpalaConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=64)
                .training(lr=2e-3, entropy_coeff=0.005)
                .learners(device="cpu").debugging(seed=0)).build()
        try:
            updates = 0
            for _ in range(ITERATIONS):
                algo.train()
            with algo._stats_lock:
                updates = algo._updates_done
        finally:
            algo.stop()
        ray_tpu_torch.timeline(str(path), spans=True)
    finally:
        ray_tpu_torch.shutdown()
    assert updates > 0
    return path


def _report(cmd, trace):
    out = subprocess.run(cmd + [str(trace), "--format=json"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_perf_report_copy_reports_the_reference_json(impala_trace):
    ref = _report([sys.executable, "tools/perf_report.py"], impala_trace)
    port = _report([sys.executable, "-m", "ray_tpu_torch.tools.perf_report"],
                   impala_trace)
    assert port == ref
    assert port["buckets"]["learner_compute"]["seconds"] > 0
    assert set(port["buckets"]) == {
        "elastic_reconfig", "host_sync", "store_rpc", "device_feed",
        "rollout_wait", "learner_compute", "idle"}
    assert abs(sum(b["pct"] for b in port["buckets"].values()) - 100) < 0.1
