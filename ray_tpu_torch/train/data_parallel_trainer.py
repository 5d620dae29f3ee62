"""DataParallelTrainer: SPMD train loops over a worker gang.

reference parity: python/ray/train/data_parallel_trainer.py:26 and
base_trainer.py:74,579 — fit() runs the training loop, spawning a
BackendExecutor (backend_executor.py:65), streaming results, persisting
checkpoints, restarting on failure per FailureConfig. The reference routes
fit() through a single-trial Tune run; here the trial loop is direct (the
Tune-equivalent integrates via the same Trainable contract in
ray_tpu_torch.tune).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                            TrainingWorkerError)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig

logger = logging.getLogger(__name__)


@dataclass
class Result:
    """reference parity: python/ray/air/result.py Result."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    path: str = ""
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def best_checkpoints(self) -> List[Checkpoint]:
        return self._best_checkpoints

    _best_checkpoints: List[Checkpoint] = field(default_factory=list)


class DataParallelTrainer:
    """Runs `train_loop_per_worker` on every rank of the gang."""

    _backend_config_cls = BackendConfig

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self._train_loop = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self._backend_config = backend_config or self._backend_config_cls()
        self._scaling_config = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._datasets = datasets
        self._resume_from = resume_from_checkpoint

    def fit(self) -> Result:
        run_name = self._run_config.name or \
            f"{type(self).__name__}_{time.strftime('%Y%m%d_%H%M%S')}"
        run_dir = os.path.join(self._run_config.storage_path, run_name)
        os.makedirs(run_dir, exist_ok=True)
        ckpt_mgr = CheckpointManager(
            run_dir, self._run_config.checkpoint_config)

        # goodput ledger for this job, bound to the driving thread:
        # every wall second of fit() lands in exactly one bucket
        # (checkpoint persists, elastic re-forms, and compile charges
        # re-attribute inside the open scopes; the rest is idle)
        from ray_tpu_torch._private import goodput
        goodput.ledger(run_name).bind()

        executor = BackendExecutor(
            self._backend_config, self._scaling_config,
            max_failures=self._run_config.failure_config.max_failures)
        executor.start()

        metrics_history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        error: Optional[BaseException] = None
        try:
            executor.start_training(
                self._train_loop, self._train_loop_config,
                checkpoint_dir=(self._resume_from.path
                                if self._resume_from else None),
                experiment_name=run_name, trial_dir=run_dir,
                datasets=self._datasets)
            while True:
                results = executor.get_next_results()
                if results is None:
                    break
                # rank-0 metrics are canonical (reference
                # data_parallel_trainer training_loop: first worker result)
                by_rank = {r.rank: r for r in results}
                r0 = by_rank.get(0, results[0])
                last_metrics = r0.metrics
                metrics_history.append(r0.metrics)
                ckpt_dirs = [r.checkpoint_dir for r in results
                             if r.checkpoint_dir]
                if ckpt_dirs:
                    # all ranks report the same logical checkpoint; rank 0
                    # (or the only reporter) wins. A vanished worker dir
                    # (e.g. HF's save_total_limit rotated it away before
                    # the copy) loses that checkpoint, not the run.
                    try:
                        persisted = ckpt_mgr.register(
                            r0.checkpoint_dir or ckpt_dirs[0],
                            r0.metrics)
                        executor.note_checkpoint(persisted.path)
                    except OSError as ce:
                        logger.warning(
                            "checkpoint dir %s disappeared before "
                            "persisting (%s); continuing",
                            r0.checkpoint_dir or ckpt_dirs[0], ce)
        except TrainingWorkerError as e:
            error = e
        finally:
            executor.shutdown()
            goodput.unbind()

        return Result(
            metrics=last_metrics,
            checkpoint=ckpt_mgr.latest,
            error=error,
            path=run_dir,
            metrics_history=metrics_history,
            _best_checkpoints=ckpt_mgr.list(),
        )

    @classmethod
    def restore(cls, path: str, **kwargs) -> "DataParallelTrainer":
        """Resume from the newest checkpoint under a prior run dir
        (reference base_trainer.py Trainer.restore). Resolution goes
        through the atomic LATEST pointer (checkpoint_manager.py) so an
        interrupted save can never be picked as the resume target."""
        from ray_tpu_torch.train.checkpoint_manager import latest_checkpoint_path
        latest = latest_checkpoint_path(path)
        if latest is None:
            raise ValueError(f"no checkpoints under {path}")
        kwargs.setdefault("resume_from_checkpoint", Checkpoint(latest))
        return cls(**kwargs)
