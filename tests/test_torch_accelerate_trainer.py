"""The port's AccelerateTrainer (a copy of the JAX package's under the
rename rule, a TorchTrainer underneath) on the CPU, held against the JAX
package's.

The reference's two tests (tests/test_train_extra_trainers.py:93-208,
both slow) run an unmodified Accelerate loop and ship an Accelerate
config with a nested DeepSpeed json to the workers. Here both packages'
_load_accelerate_config (on the driver) and
_apply_accelerate_config_on_worker (on a worker) run on the reference
test's YAML and json: what each writes is the same config, its topology
keys stripped, and the same DeepSpeed json. Then one fit() of the port's
trainer with that config runs the reference's Accelerator(cpu=True)
loop in a worker, which finds the materialized config and whose loss
falls.
"""

import json
import os
import shutil

import pytest
import yaml

import ray_tpu_torch
from ray_tpu.train import accelerate_trainer as jax_accelerate
from ray_tpu_torch.train import (AccelerateTrainer, RunConfig, ScalingConfig,
                                 TorchTrainer)
from ray_tpu_torch.train import accelerate_trainer as accelerate


@pytest.fixture()
def config_file(tmp_path):
    """The reference test's YAML (three topology keys among its settings)
    and its nested DeepSpeed json."""
    ds_file = tmp_path / "ds.json"
    ds_file.write_text(json.dumps({"zero_optimization": {"stage": 2}}))
    cfg_file = tmp_path / "accel.yaml"
    cfg_file.write_text(
        "compute_environment: LOCAL_MACHINE\n"
        "distributed_type: MULTI_CPU\n"
        "mixed_precision: 'no'\n"
        "num_machines: 99\n"
        "num_processes: 99\n"
        "main_process_ip: 1.2.3.4\n"
        f"deepspeed_config:\n  deepspeed_config_file: {ds_file}\n")
    return cfg_file, ds_file


def _materialized(module, source, monkeypatch):
    """(the config the worker side writes, the DeepSpeed json it writes),
    the json's path replaced by a marker (each run has its own tmpdir)."""
    raw, ds_raw = module._load_accelerate_config(source)
    monkeypatch.delenv("ACCELERATE_CONFIG_FILE", raising=False)
    module._apply_accelerate_config_on_worker(raw, ds_raw)
    path = os.environ["ACCELERATE_CONFIG_FILE"]
    try:
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ds = None
        if isinstance(cfg.get("deepspeed_config"), dict):
            ds_path = cfg["deepspeed_config"]["deepspeed_config_file"]
            assert os.path.dirname(ds_path) == os.path.dirname(path)
            with open(ds_path) as f:
                ds = json.load(f)
            cfg["deepspeed_config"]["deepspeed_config_file"] = "<worker>"
        return (raw, ds_raw), cfg, ds
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)


@pytest.mark.parametrize("form", ["path", "dict"])
def test_materialized_config_equals_the_reference(config_file, monkeypatch,
                                                  form):
    cfg_file, ds_file = config_file
    source = str(cfg_file) if form == "path" else \
        yaml.safe_load(cfg_file.read_text())
    ref = _materialized(jax_accelerate, source, monkeypatch)
    port = _materialized(accelerate, source, monkeypatch)
    assert port == ref
    (raw, ds_raw), cfg, ds = port
    assert ds_raw == ds_file.read_text()
    assert ds == {"zero_optimization": {"stage": 2}}
    assert cfg == {"compute_environment": "LOCAL_MACHINE",
                   "distributed_type": "MULTI_CPU", "mixed_precision": "no",
                   "deepspeed_config": {"deepspeed_config_file": "<worker>"}}
    assert not set(cfg) & set(accelerate._TOPOLOGY_KEYS)
    assert accelerate._TOPOLOGY_KEYS == jax_accelerate._TOPOLOGY_KEYS


def test_no_config_ships_nothing(monkeypatch):
    monkeypatch.delenv("ACCELERATE_CONFIG_FILE", raising=False)
    for module in (jax_accelerate, accelerate):
        module._apply_accelerate_config_on_worker(None, None)
        assert "ACCELERATE_CONFIG_FILE" not in os.environ
    assert issubclass(AccelerateTrainer, TorchTrainer)


def test_accelerate_loop_runs_and_its_loss_falls(config_file, tmp_path):
    cfg_file, ds_file = config_file

    def loop(config=None):
        import json as _json
        import os as _os

        import torch
        import yaml as _yaml
        from accelerate import Accelerator

        import ray_tpu_torch.train as train

        torch.set_num_threads(1)
        path = _os.environ.get("ACCELERATE_CONFIG_FILE", "")
        with open(path) as f:
            cfg = _yaml.safe_load(f)
        ds_path = cfg["deepspeed_config"]["deepspeed_config_file"]
        with open(ds_path) as f:
            stage = _json.load(f)["zero_optimization"]["stage"]
        accelerator = Accelerator(cpu=True)
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 1)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        xs = torch.randn(64, 4)
        ys = xs.sum(dim=1, keepdim=True)
        loader = torch.utils.data.DataLoader(
            torch.utils.data.TensorDataset(xs, ys), batch_size=16)
        model, opt, loader = accelerator.prepare(model, opt, loader)
        for epoch in range(3):
            total = 0.0
            for xb, yb in loader:
                opt.zero_grad()
                loss = torch.nn.functional.mse_loss(model(xb), yb)
                accelerator.backward(loss)
                opt.step()
                total += float(loss.detach())
            train.report({"epoch": epoch, "loss": total,
                          "distributed_type": cfg["distributed_type"],
                          "topology": sorted(set(cfg) & {
                              "num_machines", "num_processes",
                              "main_process_ip"}),
                          "ds_local": ds_path != config["driver_ds"],
                          "stage": stage})

    ray_tpu_torch.init(num_cpus=2)
    try:
        result = AccelerateTrainer(
            loop, train_loop_config={"driver_ds": str(ds_file)},
            accelerate_config=str(cfg_file),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
            run_config=RunConfig(storage_path=str(tmp_path / "runs"))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    history = result.metrics_history
    losses = [m["loss"] for m in history]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    for m in history:
        assert m["distributed_type"] == "MULTI_CPU"
        assert m["topology"] == []
        assert m["ds_local"] and m["stage"] == 2
