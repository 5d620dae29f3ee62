"""TuneController: drives N trials as actors with retries + scheduling.

reference parity: python/ray/tune/execution/tune_controller.py:73 — the
event loop owning trial actors: start up to max_concurrent, collect
results asynchronously, apply scheduler decisions (ASHA stops), retry
failed trials from their latest checkpoint, persist per-trial state under
the experiment dir (experiment/trial.py:245 Trial contract).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import CONTINUE, FIFOScheduler, STOP

logger = logging.getLogger(__name__)

PENDING, RUNNING, TERMINATED, ERROR = \
    "PENDING", "RUNNING", "TERMINATED", "ERROR"


class _TrialRunner:
    """The per-trial actor: hosts one trainable instance."""

    def __init__(self, factory: Callable[[Dict[str, Any]], Any],
                 config: Dict[str, Any]):
        self._factory = factory
        self._t = factory(config)

    def ping(self) -> str:
        return "pong"

    def reset(self, config: Dict[str, Any],
              checkpoint_dir: Optional[str] = None) -> None:
        """In-place trainable swap (reference reuse_actors /
        Trainable.reset): rebuild with a new config, optionally
        restoring a checkpoint — no actor churn, no scheduling race."""
        try:
            self._t.stop()
        except Exception:  # noqa: BLE001 - old trainable already stopped or broken
            pass
        self._t = self._factory(config)
        if checkpoint_dir:
            self._t.restore(checkpoint_dir)

    def train(self) -> Dict[str, Any]:
        return self._t.train()

    def save(self, checkpoint_dir: str) -> str:
        return self._t.save(checkpoint_dir)

    def save_auto(self, trial_dir: str) -> str:
        """Save under checkpoint_{iteration} named from the trainable's
        OWN iteration at save time. Used when the controller cannot know
        the iteration in advance (a train() is still in flight ahead of
        this call in the actor's queue, so controller-side naming would
        be one iteration behind the contents)."""
        import os
        # Trainable exposes .iteration; RLlib Algorithm keeps _iteration
        it = getattr(self._t, "iteration",
                     getattr(self._t, "_iteration", 0))
        return self._t.save(os.path.join(
            trial_dir, f"checkpoint_{int(it):06d}"))

    def restore(self, checkpoint_dir: str) -> None:
        self._t.restore(checkpoint_dir)

    def stop(self) -> None:
        self._t.stop()


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    state: str = PENDING
    actor: Any = None
    in_flight: Any = None           # ObjectRef of the pending train() call
    results: List[Dict[str, Any]] = field(default_factory=list)
    last_result: Dict[str, Any] = field(default_factory=dict)
    checkpoint_dir: Optional[str] = None
    num_failures: int = 0
    num_restores: int = 0
    error: Optional[BaseException] = None
    trial_dir: str = ""

    @property
    def iteration(self) -> int:
        return self.last_result.get("training_iteration", 0)


class TuneController:
    def __init__(self, factory: Callable[[Dict[str, Any]], Any],
                 variants: List[Dict[str, Any]], *,
                 run_dir: str,
                 stop: Optional[Dict[str, Any]] = None,
                 scheduler: Optional[Any] = None,
                 max_concurrent_trials: int = 4,
                 max_failures_per_trial: int = 1,
                 checkpoint_frequency: int = 0,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 resume_state: Optional[Dict[str, Any]] = None,
                 searcher: Optional[Any] = None,
                 num_searcher_trials: int = 0):
        self._factory = factory
        self._stop = dict(stop or {})
        self._scheduler = scheduler or FIFOScheduler()
        # sequential search algorithm (reference search_alg): suggests
        # one config per new trial, fed completed results
        self._searcher = searcher
        self._num_searcher_trials = num_searcher_trials
        self._max_concurrent = max_concurrent_trials
        self._max_failures = max_failures_per_trial
        self._ckpt_freq = checkpoint_frequency
        self._resources = dict(resources_per_trial or {"CPU": 1})
        self.run_dir = run_dir
        self.trials = [
            Trial(trial_id=f"trial_{i:05d}", config=cfg,
                  trial_dir=os.path.join(run_dir, f"trial_{i:05d}"))
            for i, cfg in enumerate(variants)
        ]
        for t in self.trials:
            os.makedirs(t.trial_dir, exist_ok=True)
        if resume_state:
            self._apply_resume_state(resume_state)
        # PBT-style schedulers track every trial's config for exploit
        if hasattr(self._scheduler, "on_trial_add"):
            for t in self.trials:
                self._scheduler.on_trial_add(t.trial_id, t.config)

    # -- experiment state (Tuner.restore; reference
    # tune/execution/experiment_state.py) ----------------------------------

    def _apply_resume_state(self, state: Dict[str, Any]) -> None:
        """Rehydrate trials: finished ones keep their results; errored /
        interrupted ones go back to PENDING and resume from their latest
        checkpoint when one exists."""
        by_id = {t["trial_id"]: t for t in state.get("trials", [])}
        for t in self.trials:
            saved = by_id.get(t.trial_id)
            if not saved:
                continue
            t.config = saved["config"]
            t.results = list(saved["results"])
            t.last_result = dict(saved["last_result"])
            t.checkpoint_dir = saved["checkpoint_dir"]
            t.num_restores = saved.get("num_restores", 0)
            t.state = (TERMINATED if saved["state"] == TERMINATED
                       else PENDING)
            if t.state == PENDING:
                # the rerun replays iterations after the checkpoint
                # (or from scratch): drop recorded results past that
                # point so training_iteration stays unique in results
                ckpt_iter = 0
                if t.checkpoint_dir:
                    tail = os.path.basename(t.checkpoint_dir)
                    if tail.startswith("checkpoint_"):
                        try:
                            ckpt_iter = int(tail.split("_")[-1])
                        except ValueError:
                            ckpt_iter = 0
                t.results = [
                    r for r in t.results
                    if r.get("training_iteration", 0) <= ckpt_iter]
                t.last_result = dict(t.results[-1]) if t.results else {}

    def experiment_state(self) -> Dict[str, Any]:
        return {"trials": [
            {"trial_id": t.trial_id, "config": t.config,
             "state": t.state, "results": t.results,
             "last_result": t.last_result,
             "checkpoint_dir": t.checkpoint_dir,
             "num_restores": t.num_restores,
             "error": repr(t.error) if t.error else None}
            for t in self.trials]}

    def _save_experiment_state(self) -> None:
        import pickle
        tmp = os.path.join(self.run_dir, ".experiment_state.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(self.experiment_state(), f)
        os.replace(tmp,
                   os.path.join(self.run_dir, "experiment_state.pkl"))

    # -- actor lifecycle ---------------------------------------------------

    def _start_trial(self, trial: Trial, restore: bool = False) -> None:
        runner_cls = ray_tpu_torch.remote(_TrialRunner)
        trial.actor = runner_cls.options(**_resource_options(
            self._resources)).remote(self._factory, trial.config)
        if restore and trial.checkpoint_dir:
            ray_tpu_torch.get(trial.actor.restore.remote(trial.checkpoint_dir),
                        timeout=300)
            trial.num_restores += 1
        trial.state = RUNNING
        trial.in_flight = trial.actor.train.remote()

    def _stop_trial(self, trial: Trial, state: str,
                    save_final: bool = True) -> None:
        if trial.actor is not None:
            try:
                if save_final and state == TERMINATED:
                    trial.checkpoint_dir = ray_tpu_torch.get(
                        trial.actor.save.remote(self._next_ckpt_dir(trial)),
                        timeout=300)
                ray_tpu_torch.get(trial.actor.stop.remote(), timeout=60)
            except Exception:  # noqa: BLE001 - wedged/dead; kill below is the backstop
                pass
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:  # noqa: BLE001 - actor already dead
                pass
        trial.actor = None
        trial.in_flight = None
        trial.state = state
        if state in (TERMINATED, ERROR):
            self._notify_searcher(trial)
            if hasattr(self._scheduler, "on_trial_remove"):
                self._scheduler.on_trial_remove(trial.trial_id)

    def _next_ckpt_dir(self, trial: Trial) -> str:
        return os.path.join(trial.trial_dir,
                            f"checkpoint_{trial.iteration:06d}")

    # -- stop conditions ---------------------------------------------------

    def _should_stop(self, result: Dict[str, Any]) -> bool:
        if result.get("done"):
            return True
        for key, bound in self._stop.items():
            if key in result and result[key] >= bound:
                return True
        return False

    # -- the loop ----------------------------------------------------------

    def _maybe_suggest_trials(self) -> None:
        """Create new trials from the searcher up to the concurrency
        cap, until its trial budget is spent (reference: SearchGenerator
        feeding TuneController)."""
        if self._searcher is None:
            return
        active = [t for t in self.trials
                  if t.state in (PENDING, RUNNING)]
        while len(self.trials) < self._num_searcher_trials and \
                len(active) < self._max_concurrent:
            trial_id = f"trial_{len(self.trials):05d}"
            cfg = self._searcher.suggest(trial_id)
            if cfg is None:
                return
            t = Trial(trial_id=trial_id, config=cfg,
                      trial_dir=os.path.join(self.run_dir, trial_id))
            os.makedirs(t.trial_dir, exist_ok=True)
            self.trials.append(t)
            active.append(t)
            if hasattr(self._scheduler, "on_trial_add"):
                self._scheduler.on_trial_add(t.trial_id, t.config)

    def _notify_searcher(self, trial: Trial) -> None:
        if self._searcher is None or \
                getattr(trial, "_searcher_notified", False):
            return
        trial._searcher_notified = True  # type: ignore[attr-defined]
        try:
            self._searcher.on_trial_complete(
                trial.trial_id, trial.last_result or None,
                error=trial.state == ERROR)
        except Exception:  # noqa: BLE001
            logger.warning("searcher on_trial_complete failed",
                           exc_info=True)

    def run(self, timeout_s: float = 3600.0) -> List[Trial]:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self._maybe_suggest_trials()
            # launch pending trials up to the concurrency cap
            running = [t for t in self.trials if t.state == RUNNING]
            pending = [t for t in self.trials if t.state == PENDING]
            for t in pending[:max(0, self._max_concurrent - len(running))]:
                try:
                    # resumed trials restart from their checkpoint
                    self._start_trial(t, restore=bool(t.checkpoint_dir))
                except Exception as e:  # noqa: BLE001
                    t.error = e
                    t.state = ERROR
                    self._notify_searcher(t)
            running = [t for t in self.trials if t.state == RUNNING]
            if not running:
                break
            refs = [t.in_flight for t in running]
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=5.0)
            if ready:
                # drain everything already finished, not just the first
                # listed trial — handling one ref per pass starves later
                # trials whenever an earlier one always has results ready
                # (schedulers then never see the starved trials' scores)
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=0)
            for ref in ready:
                trial = next(t for t in running if t.in_flight == ref)
                if trial.state == RUNNING and trial.in_flight == ref:
                    self._handle_ready(trial, ref)
        # Time budget expired: don't leak live actors (they'd keep holding
        # resources and training forever).
        for t in self.trials:
            if t.state == RUNNING:
                t.error = TimeoutError(
                    "tune run hit its time budget with this trial running")
                self._stop_trial(t, ERROR, save_final=False)
        self._save_experiment_state()
        return self.trials

    def _handle_ready(self, trial: Trial, ref: Any) -> None:
        try:
            result = ray_tpu_torch.get(ref)
        except Exception as e:  # noqa: BLE001
            self._handle_trial_failure(trial, e)
            return
        result.setdefault("trial_id", trial.trial_id)
        trial.results.append(result)
        trial.last_result = result
        # persist after every result: restore-after-hard-kill must see
        # progress, not just the state at the last trial stop
        self._save_experiment_state()
        if self._ckpt_freq and trial.iteration % self._ckpt_freq == 0:
            try:
                trial.checkpoint_dir = ray_tpu_torch.get(
                    trial.actor.save.remote(self._next_ckpt_dir(trial)),
                    timeout=300)
            except Exception:  # noqa: BLE001
                logger.warning("periodic checkpoint failed for %s",
                               trial.trial_id, exc_info=True)
        if self._should_stop(result):
            self._stop_trial(trial, TERMINATED)
            self._save_experiment_state()
            return
        decision = self._scheduler.on_result(trial.trial_id, result)
        if decision == STOP:
            logger.info("scheduler stopped %s at iter %d",
                        trial.trial_id, trial.iteration)
            self._stop_trial(trial, TERMINATED)
            self._save_experiment_state()
            return
        if isinstance(decision, dict) and \
                decision.get("action") == "exploit":
            self._exploit(trial, decision)
            self._save_experiment_state()
            return
        assert decision == CONTINUE
        trial.in_flight = trial.actor.train.remote()

    def _exploit(self, trial: Trial, decision: Dict[str, Any]) -> None:
        """PBT exploit: snapshot the source trial, then restart this
        trial from that checkpoint with the explored config (reference
        pbt.py _exploit + tune_controller trial restore path)."""
        src = next(t for t in self.trials
                   if t.trial_id == decision["source"])
        try:
            if src.state == RUNNING and src.actor is not None:
                # actor calls are ordered: save runs after the source's
                # in-flight train() completes, so the actor (not the
                # controller) must pick the checkpoint_{iteration} name
                src.checkpoint_dir = ray_tpu_torch.get(
                    src.actor.save_auto.remote(src.trial_dir),
                    timeout=300)
        except Exception:  # noqa: BLE001
            logger.warning("PBT source snapshot failed for %s",
                           src.trial_id, exc_info=True)
        if not src.checkpoint_dir:
            # no checkpoint to exploit — keep training as-is
            trial.in_flight = trial.actor.train.remote()
            return
        logger.info("PBT: %s exploits %s (new config %s)",
                    trial.trial_id, src.trial_id, decision["config"])
        trial.config = dict(decision["config"])
        trial.checkpoint_dir = src.checkpoint_dir
        try:
            # in-place reset on the same actor (reference reuse_actors)
            ray_tpu_torch.get(trial.actor.reset.remote(
                trial.config, trial.checkpoint_dir), timeout=300)
            trial.num_restores += 1
            if hasattr(self._scheduler, "confirm_exploit"):
                self._scheduler.confirm_exploit(trial.trial_id,
                                                trial.config)
            trial.in_flight = trial.actor.train.remote()
        except Exception as e:  # noqa: BLE001
            trial.error = e
            self._stop_trial(trial, ERROR, save_final=False)

    def _handle_trial_failure(self, trial: Trial,
                              error: BaseException) -> None:
        trial.num_failures += 1
        if trial.num_failures > self._max_failures:
            trial.error = error
            self._stop_trial(trial, ERROR, save_final=False)
            return
        logger.warning(
            "trial %s failed (%d/%d): %r — restarting from %s",
            trial.trial_id, trial.num_failures, self._max_failures, error,
            trial.checkpoint_dir or "scratch")
        try:
            ray_tpu_torch.kill(trial.actor)
        except Exception:  # noqa: BLE001 - actor already dead
            pass
        try:
            self._start_trial(trial, restore=True)
        except Exception as e:  # noqa: BLE001
            trial.error = e
            self._stop_trial(trial, ERROR, save_final=False)


def _resource_options(resources: Dict[str, float]) -> Dict[str, Any]:
    opts: Dict[str, Any] = {}
    res = dict(resources)
    if "CPU" in res:
        opts["num_cpus"] = res.pop("CPU")
    if "TPU" in res:
        opts["num_tpus"] = res.pop("TPU")
    if res:
        opts["resources"] = res
    return opts
