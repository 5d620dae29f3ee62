"""Trainable contract + function-trainable wrapper.

reference parity: python/ray/tune/trainable/trainable.py (the
step/save/restore contract used by TuneController, experiment/trial.py:245)
and trainable/function_trainable.py (function API with tune.report).
RLlib's Algorithm satisfies this contract natively (train/save/restore),
as does any user subclass of Trainable.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional


class Trainable:
    """Subclass API: override setup/step/save_checkpoint/load_checkpoint."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self.iteration = 0
        self.setup(self.config)

    # -- override points ----------------------------------------------
    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -- controller-facing contract (matches Algorithm.train/save/...) ----
    def train(self) -> Dict[str, Any]:
        result = self.step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        return result

    def save(self, checkpoint_dir: str) -> str:
        import json
        import os
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.save_checkpoint(checkpoint_dir)
        # Persist the iteration counter so a restored trial's
        # training_iteration (and therefore stop conditions) continues
        # where it left off (reference trainable saves .tune_metadata).
        with open(os.path.join(checkpoint_dir, ".tune_metadata"), "w") as f:
            json.dump({"iteration": self.iteration}, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        import json
        import os
        meta_path = os.path.join(checkpoint_dir, ".tune_metadata")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.iteration = json.load(f)["iteration"]
        self.load_checkpoint(checkpoint_dir)

    def stop(self) -> None:
        self.cleanup()


class _FunctionSession:
    """Bridges tune.report() inside a user function to the trial actor."""

    def __init__(self) -> None:
        self.results: "queue.Queue" = queue.Queue(maxsize=1)

    def report(self, metrics: Dict[str, Any]) -> None:
        self.results.put(("result", dict(metrics)))


_fn_session: Optional[_FunctionSession] = None


def _get_fn_session() -> Optional[_FunctionSession]:
    return _fn_session


class FunctionTrainable(Trainable):
    """Wraps fn(config) calling tune.report(...) per iteration; each
    train() returns the next reported result (reference
    function_trainable.py's result queue handshake)."""

    _fn: Callable[[Dict[str, Any]], Any] = None  # set by subclassing factory

    def setup(self, config: Dict[str, Any]) -> None:
        global _fn_session
        self._session = _FunctionSession()
        _fn_session = self._session
        self._done = False

        def runner() -> None:
            try:
                out = type(self)._fn(config)
                if isinstance(out, dict):
                    # returning a metrics dict is a final report
                    # (reference function trainables support both
                    # tune.report(...) and a returned dict)
                    self._session.results.put(("result", dict(out)))
                self._session.results.put(("done", {}))
            except BaseException as e:  # noqa: BLE001
                self._session.results.put(("error", e))

        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="tune-fn")
        self._thread.start()

    def step(self) -> Dict[str, Any]:
        if self._done:
            return {"done": True}
        kind, payload = self._session.results.get()
        if kind == "error":
            raise payload
        if kind == "done":
            self._done = True
            return {"done": True}
        payload.setdefault("done", False)
        return payload

    def restore(self, checkpoint_dir: str) -> None:
        # A function trainable replays fn(config) from its beginning on
        # restart — resuming the iteration counter from .tune_metadata
        # would mislabel the replayed reports and truncate the run against
        # iteration-based stop conditions. Restarts are from scratch.
        self.iteration = 0


def wrap_function(fn: Callable[[Dict[str, Any]], Any]) -> type:
    return type(f"fn_{getattr(fn, '__name__', 'trainable')}",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})


def report(metrics: Optional[Dict[str, Any]] = None, **kwargs: Any) -> None:
    """tune.report inside a function trainable."""
    s = _get_fn_session()
    if s is None:
        raise RuntimeError("tune.report() called outside a tune function "
                           "trainable")
    merged = dict(metrics or {})
    merged.update(kwargs)
    s.report(merged)
