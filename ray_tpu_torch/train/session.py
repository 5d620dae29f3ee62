"""Worker-side training session.

reference parity: python/ray/train/_internal/session.py — _TrainSession
(:109), report (:653, via :393 _report_thread_runner_error plumbing),
get_checkpoint (:711), world_rank/world_size accessors. The user's
train_loop_per_worker runs on a daemon thread; `report(metrics,
checkpoint=...)` hands a result to the driver and blocks until consumed
(queue of size 1 — keeps workers paced with the driver like the
reference's result queue).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclasses.dataclass
class TrainContext:
    """What a worker knows about itself (reference session accessors
    get_world_rank/get_world_size/get_local_rank/...)."""

    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = ""
    trial_dir: str = ""
    # Gang heartbeat channel id (train/heartbeat.py): set per gang
    # FORMATION by the backend executor — each elastic re-form gets a
    # fresh id so stale rows from a torn-down generation never shadow
    # the new gang. Empty = no heartbeat sidecar.
    gang_id: str = ""

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_dir(self) -> str:
        return self.trial_dir


@dataclasses.dataclass
class TrainingResult:
    """One report() payload (reference _internal/session.py
    _TrainingResult)."""

    metrics: Dict[str, Any]
    checkpoint_dir: Optional[str] = None   # worker-local materialized dir
    rank: int = 0
    final: bool = False                     # loop returned
    error: Optional[BaseException] = None


class _TrainSession:
    """Runs the user loop on a thread; bridges report() to the driver."""

    def __init__(self, train_loop: Callable[..., Any],
                 config: Optional[Dict[str, Any]],
                 context: TrainContext,
                 starting_checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.context = context
        self.starting_checkpoint = starting_checkpoint
        self.dataset_shards = dataset_shards or {}
        self._results: "queue.Queue[TrainingResult]" = queue.Queue(maxsize=1)
        self._loop = train_loop
        self._config = config
        self._thread: Optional[threading.Thread] = None
        self._finished = False
        self._heartbeat = None

    # -- worker-loop side --------------------------------------------
    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        if self._heartbeat is not None:
            # the report round IS the supervisor's step unit: its
            # deadline is calibrated on report->report time
            self._heartbeat.note_step()
            self._heartbeat.set_phase("train")
        self._results.put(TrainingResult(
            metrics=dict(metrics),
            checkpoint_dir=checkpoint.path if checkpoint else None,
            rank=self.context.world_rank))

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.starting_checkpoint

    # -- actor side ---------------------------------------------------
    def start(self) -> None:
        if self.context.gang_id:
            # heartbeat sidecar: beats from its own thread + RpcClient
            # even while the loop thread sits inside a collective. A
            # SIGSTOP freezes it too — a STALE beat is the wedge signal.
            from ray_tpu_torch.train.heartbeat import HeartbeatSender
            hb = HeartbeatSender(self.context.gang_id,
                                 self.context.world_rank)
            if hb.start():
                self._heartbeat = hb

        def runner():
            try:
                if self._config is not None:
                    self._loop(self._config)
                else:
                    self._loop()
                if self._heartbeat is not None:
                    self._heartbeat.set_phase("done")
                self._results.put(TrainingResult(
                    metrics={}, rank=self.context.world_rank, final=True))
            except BaseException as e:  # noqa: BLE001
                self._results.put(TrainingResult(
                    metrics={}, rank=self.context.world_rank, final=True,
                    error=e))

        self._thread = threading.Thread(
            target=runner, daemon=True,
            name=f"train-loop-rank{self.context.world_rank}")
        self._thread.start()

    def close(self) -> None:
        """Stop the heartbeat sidecar (gang teardown)."""
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None

    def next_result(self, timeout: Optional[float] = None
                    ) -> Optional[TrainingResult]:
        """Block for the next report()/completion; None only on timeout."""
        if self._finished:
            return TrainingResult(metrics={},
                                  rank=self.context.world_rank, final=True)
        try:
            result = self._results.get(timeout=timeout)
        except queue.Empty:
            return None
        if result.final:
            self._finished = True
        return result


# Module-level session (one per worker process, like the reference's
# thread-local _session in _internal/session.py).
_session: Optional[_TrainSession] = None


def _set_session(s: Optional[_TrainSession]) -> None:
    global _session
    _session = s


def _get_session_or_raise() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active: ray_tpu_torch.train.report()/"
            "get_context() only work inside train_loop_per_worker")
    return _session


# -- public API (ray_tpu_torch.train.{report,get_checkpoint,get_context}) ----
def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """reference train/_internal/session.py:653 ray.train.report."""
    _get_session_or_raise().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    """reference session.py:711 ray.train.get_checkpoint."""
    return _get_session_or_raise().get_checkpoint()


def get_context() -> TrainContext:
    """reference ray.train.get_context()."""
    return _get_session_or_raise().context


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed to the trainer (reference
    train/_internal/session.py:1017 get_dataset_shard). Returns a
    ray_tpu_torch.data.DataIterator."""
    shards = _get_session_or_raise().dataset_shards
    if name not in shards:
        raise KeyError(
            f"no dataset shard named {name!r}: trainer was given "
            f"datasets={list(shards)}")
    return shards[name]
