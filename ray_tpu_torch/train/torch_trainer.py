"""TorchTrainer: torch train loops over a torch.distributed process group.

The port's counterpart of ray_tpu/train/jax_trainer.py (reference
parity: python/ray/train/torch/torch_trainer.py): a DataParallelTrainer
whose backend (TorchConfig) joins the gang into an NCCL process group
when the workers hold GPUs, gloo otherwise. The per-worker loop builds a
data mesh (parallel.make_mesh), runs make_train_step over it and
report()s metrics and checkpoints.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch_backend import TorchConfig


class TorchTrainer(DataParallelTrainer):
    _backend_config_cls = TorchConfig

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)
