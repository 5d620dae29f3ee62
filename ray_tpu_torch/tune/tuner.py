"""Tuner: the public experiment API over TuneController.

reference parity: python/ray/tune/tuner.py:54 (Tuner.fit → ResultGrid)
+ tune/tune.py run(). Accepts a function trainable, a Trainable subclass,
an rllib AlgorithmConfig (variants merge into .training(**cfg)), or a
DataParallelTrainer instance (variants merge into train_loop_config).
"""

from __future__ import annotations

import inspect
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.tune.search import BasicVariantGenerator
from ray_tpu_torch.tune.trainable import Trainable, wrap_function
from ray_tpu_torch.tune.tune_controller import TuneController


@dataclass
class TuneConfig:
    """reference tune/tune_config.py TuneConfig."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None
    search_seed: Optional[int] = None
    # sequential search algorithm (a tune.search.Searcher, e.g.
    # TPESearcher / OptunaSearcher); when set, num_samples trials are
    # suggested one-by-one with results fed back (reference search_alg)
    search_alg: Any = None


@dataclass
class TuneRunConfig:
    """Experiment-level config (reference air RunConfig for Tune runs)."""

    name: str = ""
    storage_path: str = "/tmp/ray_tpu_results"
    stop: Optional[Dict[str, Any]] = None
    max_failures_per_trial: int = 1
    checkpoint_frequency: int = 0
    resources_per_trial: Dict[str, float] = field(
        default_factory=lambda: {"CPU": 1.0})


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    metrics_history: List[Dict[str, Any]]
    checkpoint_dir: Optional[str]
    error: Optional[BaseException]
    state: str
    num_restores: int = 0


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i: int) -> TrialResult:
        return self._results[i]

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("no metric given (TuneConfig.metric or arg)")
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])


def _make_factory(trainable: Any) -> Callable[[Dict[str, Any]], Any]:
    """Normalize the four accepted trainable kinds into factory(config)."""
    from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
    if isinstance(trainable, AlgorithmConfig):
        base = trainable

        def algo_factory(config: Dict[str, Any]):
            return base.copy().training(**config).build()
        return algo_factory
    from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
    if isinstance(trainable, DataParallelTrainer):
        return _TrainerTrainableFactory(trainable)
    if inspect.isclass(trainable) and issubclass(trainable, Trainable):
        return trainable
    if callable(trainable):
        return wrap_function(trainable)
    raise TypeError(f"unsupported trainable: {trainable!r}")


class _TrainerTrainableFactory:
    """Each trial clones the trainer with the variant merged into
    train_loop_config and fit()s it once (reference
    BaseTrainer.as_trainable, base_trainer.py:839)."""

    def __init__(self, trainer: Any):
        self._trainer = trainer

    def __call__(self, config: Dict[str, Any]):
        import copy

        trainer = copy.copy(self._trainer)
        merged = dict(trainer._train_loop_config or {})
        merged.update(config)
        trainer._train_loop_config = merged

        class _OneShot(Trainable):
            def step(inner) -> Dict[str, Any]:
                result = trainer.fit()
                if result.error is not None:
                    raise result.error
                out = dict(result.metrics)
                out["done"] = True
                inner._result = result
                return out

        return _OneShot(config)


class Tuner:
    def __init__(self, trainable: Any, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[TuneRunConfig] = None):
        self._trainable = trainable
        self._param_space = dict(param_space or {})
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or TuneRunConfig()
        self._resume_state: Optional[Dict[str, Any]] = None
        self._resume_dir: Optional[str] = None

    @classmethod
    def restore(cls, path: str, trainable: Any) -> "Tuner":
        """Resume an interrupted/failed experiment from its run dir
        (reference Tuner.restore, tuner.py). Finished trials keep their
        results; unfinished or errored trials rerun, restoring from
        their latest checkpoint when one exists. The original
        tune/run configs reload from the run dir."""
        import pickle
        state_file = os.path.join(path, "experiment_state.pkl")
        with open(state_file, "rb") as f:
            state = pickle.load(f)
        tune_config = run_config = None
        meta_file = os.path.join(path, "tuner_config.pkl")
        if os.path.exists(meta_file):
            with open(meta_file, "rb") as f:
                meta = pickle.load(f)
            tune_config = meta.get("tune_config")
            run_config = meta.get("run_config")
        else:
            import logging
            logging.getLogger(__name__).warning(
                "no tuner_config.pkl under %s (original configs were "
                "unpicklable?) — resuming with DEFAULT TuneConfig/"
                "TuneRunConfig: no scheduler, no stop conditions", path)
        tuner = cls(trainable, tune_config=tune_config,
                    run_config=run_config)
        tuner._resume_state = state
        tuner._resume_dir = path
        return tuner

    def fit(self) -> ResultGrid:
        tc, rc = self._tune_config, self._run_config
        if self._resume_dir:
            run_dir = self._resume_dir
            variants = [t["config"]
                        for t in self._resume_state["trials"]]
        else:
            name = rc.name or f"tune_{time.strftime('%Y%m%d_%H%M%S')}"
            run_dir = os.path.join(rc.storage_path, name)
            os.makedirs(run_dir, exist_ok=True)
            variants = [] if tc.search_alg is not None else list(
                BasicVariantGenerator(
                    self._param_space, num_samples=tc.num_samples,
                    seed=tc.search_seed).variants())
            import pickle
            try:
                with open(os.path.join(run_dir, "tuner_config.pkl"),
                          "wb") as f:
                    pickle.dump({"tune_config": tc, "run_config": rc,
                                 "param_space": self._param_space}, f)
            except Exception:  # noqa: BLE001 — unpicklable scheduler etc.
                pass
        controller = TuneController(
            _make_factory(self._trainable), variants,
            run_dir=run_dir, stop=rc.stop, scheduler=tc.scheduler,
            max_concurrent_trials=tc.max_concurrent_trials,
            max_failures_per_trial=rc.max_failures_per_trial,
            checkpoint_frequency=rc.checkpoint_frequency,
            resources_per_trial=rc.resources_per_trial,
            resume_state=self._resume_state,
            searcher=tc.search_alg,
            num_searcher_trials=(tc.num_samples
                                 if tc.search_alg is not None else 0))
        trials = controller.run()
        results = [
            TrialResult(
                trial_id=t.trial_id, config=t.config,
                metrics=t.last_result, metrics_history=t.results,
                checkpoint_dir=t.checkpoint_dir, error=t.error,
                state=t.state, num_restores=t.num_restores)
            for t in trials
        ]
        return ResultGrid(results, tc.metric, tc.mode)
