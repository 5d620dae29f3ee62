"""The port's TensorflowTrainer and TensorflowConfig on the CPU, held
against the JAX package's.

tensorflow_trainer.py is a verbatim copy (in VERBATIM of
tests/test_torch_runtime.py); tensorflow_backend.py is a copy with one
line edited: it takes _get_node_ip from the port's torch_backend (the
JAX package's comes from its jax_backend, which the port does not have).
Both packages' _set_tf_config write the same TF_CONFIG for the same
addresses and rank. A 2-worker CPU gang of the port's trainer gives each
rank both (distinct) addresses, its own index and task type "worker".
TensorFlow itself is not imported: the reference measured ~70 s for
that across two workers (tests/test_train_tf.py:22), so the reference
test's in-worker TF matmul stays unmirrored.
"""

import json
import os
import sys
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu.train import tensorflow_backend as jax_tf_backend
from ray_tpu_torch.train import (RunConfig, ScalingConfig, TensorflowConfig,
                                 TensorflowTrainer)
from ray_tpu_torch.train import tensorflow_backend as tf_backend

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_runtime import rename  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

EDITED_IMPORT = (
    "from ray_tpu_torch.train.jax_backend import _get_node_ip\n",
    "from ray_tpu_torch.train.torch_backend import _get_node_ip\n")


def test_backend_is_the_reference_but_for_the_node_address():
    ref = rename((REPO / "ray_tpu/train/tensorflow_backend.py").read_text())
    before, after = EDITED_IMPORT
    assert ref.count(before) == 1
    port = (REPO / "ray_tpu_torch/train/tensorflow_backend.py").read_text()
    assert port == ref.replace(before, after)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_tf_config_json_equals_the_reference(monkeypatch, rank):
    addresses = ["10.0.0.1:2222", "10.0.0.2:2223", "127.0.0.1:40001"]
    got = []
    for module in (jax_tf_backend, tf_backend):
        monkeypatch.delenv("TF_CONFIG", raising=False)
        module._set_tf_config(addresses, rank)
        got.append(os.environ["TF_CONFIG"])
    assert got[0] == got[1]
    assert json.loads(got[1]) == {"cluster": {"worker": addresses},
                                  "task": {"type": "worker", "index": rank}}


def test_backend_config_is_the_reference_dataclass():
    from ray_tpu.train import TensorflowConfig as JaxTensorflowConfig
    assert TensorflowConfig().backend_cls is tf_backend._TensorflowBackend
    assert JaxTensorflowConfig().backend_cls.__name__ == "_TensorflowBackend"
    assert TensorflowTrainer._backend_config_cls is TensorflowConfig


def test_each_rank_of_a_two_worker_gang_sees_its_tf_config(tmp_path):
    out = tmp_path / "ranks"
    out.mkdir()

    def loop(config):
        import json as _json
        import os as _os

        from ray_tpu_torch import train
        tf_config = _json.loads(_os.environ["TF_CONFIG"])
        rank = train.get_context().get_world_rank()
        with open(_os.path.join(config["out"], f"{rank}.json"), "w") as f:
            _json.dump({"rank": rank, "tf_config": tf_config}, f)
        train.report({"index": tf_config["task"]["index"],
                      "num_workers": len(tf_config["cluster"]["worker"])})

    ray_tpu_torch.init(num_cpus=2)
    try:
        result = TensorflowTrainer(
            loop, train_loop_config={"out": str(out)},
            scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
            run_config=RunConfig(storage_path=str(tmp_path / "runs"))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    assert result.metrics == {"index": 0, "num_workers": 2}
    seen = [json.loads((out / f"{r}.json").read_text()) for r in (0, 1)]
    workers = seen[0]["tf_config"]["cluster"]["worker"]
    assert len(workers) == len(set(workers)) == 2
    for r, view in enumerate(seen):
        assert view["rank"] == r
        assert view["tf_config"] == {
            "cluster": {"worker": workers},
            "task": {"type": "worker", "index": r}}
        host, port = view["tf_config"]["cluster"]["worker"][r].rsplit(":", 1)
        assert host == "127.0.0.1" and int(port) > 0
