"""SklearnTrainer: scikit-learn estimator fitting as a train run.

reference parity: python/ray/train/sklearn/sklearn_trainer.py — fits a
(non-distributed) sklearn estimator on one training actor, optionally
cross-validates, reports metrics and persists the fitted estimator as
the run checkpoint. Parallelism comes from the estimator's own n_jobs
(the reference registers a joblib-over-actors backend; here the single
fitting actor keeps its requested CPUs).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import Result


class SklearnTrainer:
    def __init__(self, *, estimator: Any,
                 datasets: Dict[str, Any],
                 label_column: str,
                 params: Optional[Dict[str, Any]] = None,
                 scoring: Optional[str] = None,
                 cv: Optional[int] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None):
        if "train" not in datasets:
            raise ValueError("datasets must include a 'train' entry")
        self.estimator = estimator
        self.datasets = datasets
        self.label_column = label_column
        self.params = dict(params or {})
        self.scoring = scoring
        self.cv = cv
        self.scaling_config = scaling_config or ScalingConfig(
            trainer_resources={"CPU": 1})
        self.run_config = run_config or RunConfig()

    def fit(self) -> Result:
        import ray_tpu_torch

        run_name = self.run_config.name or \
            f"SklearnTrainer_{time.strftime('%Y%m%d_%H%M%S')}"
        run_dir = os.path.join(self.run_config.storage_path, run_name)
        os.makedirs(run_dir, exist_ok=True)

        def _fit(estimator_blob: bytes, datasets: Dict[str, Any],
                 label: str, params: Dict[str, Any],
                 scoring: Optional[str], cv: Optional[int],
                 run_dir: str) -> Dict[str, Any]:
            import numpy as np
            import pickle as _p
            est = _p.loads(estimator_blob)
            if params:
                est.set_params(**params)

            def split(block):
                y = np.asarray(block[label])
                feats = [np.asarray(v) for k, v in sorted(block.items())
                         if k != label]
                X = np.column_stack(feats)
                return X, y

            Xtr, ytr = split(datasets["train"])
            metrics: Dict[str, Any] = {}
            if cv:
                from sklearn.model_selection import cross_val_score
                scores = cross_val_score(est, Xtr, ytr, cv=cv,
                                         scoring=scoring)
                metrics["cv_scores"] = [float(s) for s in scores]
                metrics["cv_score_mean"] = float(np.mean(scores))
            t0 = time.perf_counter()
            est.fit(Xtr, ytr)
            metrics["fit_time"] = time.perf_counter() - t0
            metrics["train_score"] = float(est.score(Xtr, ytr))
            for name, block in datasets.items():
                if name == "train":
                    continue
                Xv, yv = split(block)
                metrics[f"{name}_score"] = float(est.score(Xv, yv))
            ckpt_dir = os.path.join(run_dir, "_worker_staging")
            os.makedirs(ckpt_dir, exist_ok=True)
            with open(os.path.join(ckpt_dir, "estimator.pkl"),
                      "wb") as f:
                _p.dump(est, f)
            metrics["checkpoint_dir"] = ckpt_dir
            return metrics

        cpus = (self.scaling_config.trainer_resources or
                {"CPU": 1}).get("CPU", 1)
        fit_remote = ray_tpu_torch.remote(_fit).options(num_cpus=cpus)
        try:
            metrics = ray_tpu_torch.get(fit_remote.remote(
                pickle.dumps(self.estimator), self.datasets,
                self.label_column, self.params, self.scoring, self.cv,
                run_dir), timeout=3600)
        except Exception as e:  # noqa: BLE001 — same contract as the
            # other trainers: errors surface on Result.error, not raise
            return Result(metrics={}, checkpoint=None, error=e,
                          path=run_dir)
        ckpt_dir = metrics.pop("checkpoint_dir")
        # register through the shared manager so
        # RunConfig.checkpoint_config (num_to_keep, score attr) applies
        from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
        mgr = CheckpointManager(run_dir,
                                self.run_config.checkpoint_config)
        ckpt = mgr.register(ckpt_dir, metrics)
        import shutil
        shutil.rmtree(ckpt_dir, ignore_errors=True)  # staged copy
        return Result(metrics=metrics, checkpoint=ckpt,
                      error=None, path=run_dir,
                      metrics_history=[dict(metrics)],
                      _best_checkpoints=mgr.list())
