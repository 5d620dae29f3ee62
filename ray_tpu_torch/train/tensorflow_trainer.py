"""TensorflowTrainer: tf train loops with TF_CONFIG wiring.

reference parity: python/ray/train/tensorflow/tensorflow_trainer.py — a
DataParallelTrainer whose backend writes TF_CONFIG for
MultiWorkerMirroredStrategy instead of the jax coordinator (§8.4
trainer inventory row).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.tensorflow_backend import TensorflowConfig


class TensorflowTrainer(DataParallelTrainer):
    _backend_config_cls = TensorflowConfig

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 tensorflow_config: Optional[TensorflowConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=tensorflow_config or TensorflowConfig(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)
