"""AccelerateTrainer: HF Accelerate loops with config-file propagation.

reference parity: python/ray/train/huggingface/accelerate/
accelerate_trainer.py:44-110 — beyond TorchTrainer it (1) loads and
parses an Accelerate configuration (path from `accelerate config`, a
dict, or the default config location) ONCE on the driver, (2) ships the
raw contents to every worker and materializes them there (including a
nested DeepSpeed json referenced by `deepspeed_config_file`), pointing
`ACCELERATE_CONFIG_FILE` at the materialized copy so `Accelerator()`
picks it up, and (3) strips the topology keys the gang already owns
(num_processes / machine_rank / main_process_ip ... come from the
torch process group env the backend wired), mirroring the reference's
"ignored and automatically set" list.

TPU-first note: as with TransformersTrainer this exists for torch-side
parity — TPU training's first-class path is JaxTrainer.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.torch_backend import TorchConfig
from ray_tpu_torch.train.torch_trainer import TorchTrainer

# Accelerate config keys the gang topology owns (reference
# accelerate_trainer.py "will be ignored and automatically set"):
_TOPOLOGY_KEYS = (
    "num_machines", "num_processes", "machine_rank", "gpu_ids",
    "num_cpu_threads_per_process", "main_process_ip",
    "main_process_port", "same_network", "cpu", "use_cpu",
    "rdzv_backend", "main_training_function",
)


def _load_accelerate_config(accelerate_config
                            ) -> Tuple[Optional[str], Optional[str]]:
    """Driver-side load (reference _accelerate_utils.load_accelerate_config):
    returns (config_yaml_raw, deepspeed_json_raw)."""
    if accelerate_config is None:
        # default location as defined by Accelerate, if one exists
        try:
            from accelerate.commands.config import default_config_file
            if os.path.exists(default_config_file):
                accelerate_config = default_config_file
            else:
                return None, None
        except ImportError:
            return None, None
    # yaml only becomes a requirement once a config actually loads
    import yaml
    if isinstance(accelerate_config, dict):
        cfg = dict(accelerate_config)
    else:
        with open(os.fspath(accelerate_config)) as f:
            cfg = yaml.safe_load(f) or {}
    ds_raw = None
    ds_cfg = cfg.get("deepspeed_config")
    if isinstance(ds_cfg, dict) and ds_cfg.get("deepspeed_config_file"):
        # nested DeepSpeed json also ships by value (the path is only
        # meaningful on the driver's filesystem)
        with open(ds_cfg["deepspeed_config_file"]) as f:
            ds_raw = f.read()
    return yaml.safe_dump(cfg), ds_raw


def _apply_accelerate_config_on_worker(config_raw: Optional[str],
                                       deepspeed_raw: Optional[str]
                                       ) -> None:
    """Materialize the shipped config on this worker and point
    ACCELERATE_CONFIG_FILE at it; topology keys are dropped so
    Accelerate reads them from the process-group env instead."""
    import tempfile

    import yaml

    if config_raw is None:
        return
    cfg = yaml.safe_load(config_raw) or {}
    for key in _TOPOLOGY_KEYS:
        cfg.pop(key, None)
    tmpdir = tempfile.mkdtemp(prefix="accelerate_cfg_")
    if deepspeed_raw is not None and isinstance(
            cfg.get("deepspeed_config"), dict):
        ds_path = os.path.join(tmpdir, "deepspeed_config.json")
        with open(ds_path, "w") as f:
            f.write(deepspeed_raw)
        cfg["deepspeed_config"]["deepspeed_config_file"] = ds_path
    path = os.path.join(tmpdir, "accelerate_config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    os.environ["ACCELERATE_CONFIG_FILE"] = path


class AccelerateTrainer(TorchTrainer):
    """TorchTrainer + Accelerate config loading/propagation. The user
    `train_loop_per_worker` constructs `accelerate.Accelerator()` as it
    would outside Ray; the torch process group and the materialized
    config file are already in place on every worker."""

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 accelerate_config=None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        config_raw, ds_raw = _load_accelerate_config(accelerate_config)

        def wrapped(config=None, _loop=train_loop_per_worker,
                    _raw=config_raw, _ds=ds_raw):
            _apply_accelerate_config_on_worker(_raw, _ds)
            if config is None:
                return _loop()
            return _loop(config)

        super().__init__(
            wrapped,
            train_loop_config=train_loop_config,
            torch_config=torch_config,
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)
