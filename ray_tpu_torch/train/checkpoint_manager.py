"""Checkpoint bookkeeping: persist, rank, prune.

reference parity: python/ray/train/_internal/checkpoint_manager.py:43
(_CheckpointManager) honoring CheckpointConfig (air/config.py:428 —
num_to_keep, checkpoint_score_attribute/order).

Persistence is ATOMIC (tmp dir + per-file fsync + rename, directory
fsync'd) and the LATEST pointer file is updated LAST, also via
tmp+fsync+rename: a crash or chaos kill at ANY instant during a save
leaves either the previous pointer naming a complete checkpoint or the
new pointer naming the new complete checkpoint — never a torn resume
target. Unreferenced `.tmp-*` debris from an interrupted copy is
ignored by readers and swept on the next persist.
"""

from __future__ import annotations

import os
import shutil
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import CheckpointConfig

LATEST_POINTER = "LATEST"


@dataclass
class _TrackedCheckpoint:
    checkpoint: Checkpoint
    metrics: Dict[str, Any] = field(default_factory=dict)
    index: int = 0
    time: float = field(default_factory=time.time)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _copy_fsync(src: str, dest: str) -> None:
    """copytree whose every file is flushed to disk before the caller
    renames the tree into place — the rename must never publish a
    directory whose file contents are still only in the page cache."""
    os.makedirs(dest, exist_ok=True)
    for root, dirs, files in os.walk(src):
        rel = os.path.relpath(root, src)
        out_root = dest if rel == "." else os.path.join(dest, rel)
        for d in dirs:
            os.makedirs(os.path.join(out_root, d), exist_ok=True)
        for name in files:
            out_path = os.path.join(out_root, name)
            with open(os.path.join(root, name), "rb") as fin, \
                    open(out_path, "wb") as fout:
                shutil.copyfileobj(fin, fout)
                fout.flush()
                os.fsync(fout.fileno())
        _fsync_dir(out_root)


def read_latest_pointer(run_dir: str) -> Optional[str]:
    """The path the LATEST pointer names, or None. Only ever names a
    fully-persisted checkpoint (the pointer is written after the data
    rename lands)."""
    p = os.path.join(run_dir, LATEST_POINTER)
    try:
        with open(p) as f:
            name = f.read().strip()
    except OSError:
        return None
    path = os.path.join(run_dir, name)
    return path if name and os.path.isdir(path) else None


def latest_checkpoint_path(run_dir: str) -> Optional[str]:
    """Resolve the resume target under a run dir: the LATEST pointer
    when present, else the newest complete checkpoint_* dir (pre-pointer
    runs). `.tmp-*` debris from interrupted persists never qualifies."""
    p = read_latest_pointer(run_dir)
    if p is not None:
        return p
    ckpts = sorted(
        d for d in os.listdir(run_dir)
        if d.startswith("checkpoint_")
        and os.path.isdir(os.path.join(run_dir, d)))
    return os.path.join(run_dir, ckpts[-1]) if ckpts else None


class CheckpointManager:
    def __init__(self, run_dir: str,
                 config: Optional[CheckpointConfig] = None):
        self.run_dir = run_dir
        self.config = config or CheckpointConfig()
        self._checkpoints: List[_TrackedCheckpoint] = []
        os.makedirs(run_dir, exist_ok=True)
        # Resume numbering past any checkpoints a prior run left in this
        # run dir: a fresh manager starting at 0 would target an existing
        # checkpoint_000001 and os.rename into a non-empty dir fails.
        self._counter = 0
        for d in os.listdir(run_dir):
            if d.startswith("checkpoint_"):
                try:
                    self._counter = max(self._counter,
                                        int(d.rsplit("_", 1)[-1]))
                except ValueError:
                    pass

    @property
    def latest(self) -> Optional[Checkpoint]:
        return self._checkpoints[-1].checkpoint if self._checkpoints else None

    @property
    def best(self) -> Optional[Checkpoint]:
        ranked = self._ranked()
        return ranked[0].checkpoint if ranked else None

    def list(self) -> List[Checkpoint]:
        return [t.checkpoint for t in self._checkpoints]

    def register(self, worker_dir: str,
                 metrics: Dict[str, Any]) -> Checkpoint:
        """Persist a worker-reported checkpoint dir into the run dir:
        copy+fsync into a tmp dir, rename into place, THEN advance the
        LATEST pointer — a kill mid-save can never leave a torn dir as
        the resume target."""
        from ray_tpu_torch._private import goodput
        with goodput.bucket("checkpoint_save"):
            return self._register_impl(worker_dir, metrics)

    def _register_impl(self, worker_dir: str,
                       metrics: Dict[str, Any]) -> Checkpoint:
        self._sweep_tmp()
        self._counter += 1
        name = f"checkpoint_{self._counter:06d}"
        dest = os.path.join(self.run_dir, name)
        if os.path.abspath(worker_dir) != dest:
            tmp = os.path.join(self.run_dir,
                               f".tmp-{name}-{uuid.uuid4().hex[:8]}")
            try:
                _copy_fsync(worker_dir, tmp)
                os.rename(tmp, dest)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            _fsync_dir(self.run_dir)
        self._write_latest_pointer(name)
        ckpt = Checkpoint(dest)
        self._checkpoints.append(_TrackedCheckpoint(
            checkpoint=ckpt, metrics=dict(metrics), index=self._counter))
        self._prune()
        return ckpt

    def _write_latest_pointer(self, name: str) -> None:
        """Atomic pointer update, strictly AFTER the checkpoint data
        rename: readers either see the previous pointer (previous valid
        checkpoint) or the new one (new valid checkpoint)."""
        final = os.path.join(self.run_dir, LATEST_POINTER)
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        _fsync_dir(self.run_dir)

    def _sweep_tmp(self) -> None:
        """Clear debris a previous interrupted persist left behind
        (never referenced by the pointer, never ranked)."""
        for d in os.listdir(self.run_dir):
            if d.startswith(".tmp-") or (d.startswith(LATEST_POINTER)
                                         and d != LATEST_POINTER):
                p = os.path.join(self.run_dir, d)
                if os.path.isdir(p):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass

    def _ranked(self) -> List[_TrackedCheckpoint]:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return list(reversed(self._checkpoints))  # newest first

        def score(t: _TrackedCheckpoint):
            return t.metrics.get(attr, float("-inf"))

        return sorted(self._checkpoints, key=score,
                      reverse=self.config.checkpoint_score_order == "max")

    def _prune(self) -> None:
        keep = self.config.num_to_keep
        if keep is None or len(self._checkpoints) <= keep:
            return
        ranked = self._ranked()
        doomed = ranked[keep:]
        # never delete the most recent checkpoint: restarts resume from it
        latest = self._checkpoints[-1]
        for t in doomed:
            if t is latest:
                continue
            self._checkpoints.remove(t)
            shutil.rmtree(t.checkpoint.path, ignore_errors=True)
