"""Offline sample IO: JSONL fragment files.

reference parity: rllib/offline/json_writer.py (JsonWriter — sampled
batches to .json shards, rolling over at max_file_size) and
json_reader.py (JsonReader — reads shards, cycling forever for
training). Batches here are rollout *fragments* (the [T, N, ...] column
dicts EnvRunner.sample returns) so offline postprocessing (GAE for
MARWIL) can run exactly like the online path. Arrays encode as nested
lists with an explicit dtype tag; nesting carries the shape.
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def _encode(value: Any) -> Any:
    if isinstance(value, np.ndarray):
        return {"__nd__": value.tolist(), "dtype": str(value.dtype)}
    if isinstance(value, (np.integer, np.floating, np.bool_)):
        return value.item()
    return value


def _decode(value: Any) -> Any:
    if isinstance(value, dict) and "__nd__" in value:
        return np.asarray(value["__nd__"],
                          dtype=np.dtype(value["dtype"]))
    return value


class JsonWriter:
    """Append rollout fragments to JSONL shards under `path`."""

    def __init__(self, path: str,
                 max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        self.max_file_size = max_file_size
        os.makedirs(path, exist_ok=True)
        self._shard = 0
        self._file = None

    def _current(self):
        if self._file is None or self._file.tell() > self.max_file_size:
            if self._file is not None:
                self._file.close()
                self._shard += 1
            name = os.path.join(self.path,
                                f"output-{self._shard:05d}.jsonl")
            self._file = open(name, "a", encoding="utf-8")
        return self._file

    def write(self, fragment: Dict[str, Any]) -> None:
        row = {k: _encode(v) for k, v in fragment.items()
               if k != "episode_metrics"}
        f = self._current()
        f.write(json.dumps(row) + "\n")
        f.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class JsonReader:
    """Cycle through JSONL shards, yielding decoded fragments.

    Shards are decoded lazily with at most `max_cached_shards` decoded
    shards held in memory (the reference JsonReader likewise streams
    shards instead of materializing the whole dataset). With `shuffle`
    on, fragments are drawn from a WORKING SET of up to
    `max_cached_shards` concurrently-open shards — each draw picks a
    shard weighted by its remaining fragments, then a random fragment
    within it; exhausted shards are replaced from the (reshuffled per
    epoch) shard order. This mixes consecutive samples across shards at
    bounded memory, so shard-correlated datasets (one shard per worker/
    policy) don't feed long single-shard runs to the learner.
    """

    def __init__(self, path: str, shuffle: bool = True,
                 seed: Optional[int] = None,
                 max_cached_shards: int = 2):
        if os.path.isdir(path):
            pattern = os.path.join(path, "*.jsonl")
        else:
            pattern = path
        self.files: List[str] = sorted(_glob.glob(pattern))
        if not self.files:
            raise FileNotFoundError(f"no offline data at {pattern!r}")
        # count fragments per shard without decoding (cheap line scan)
        self._counts: List[int] = []
        for fn in self.files:
            n = 0
            with open(fn, encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        n += 1
            self._counts.append(n)
        # drop empty shards so the cycle loop never stalls on one
        keep = [i for i, n in enumerate(self._counts) if n > 0]
        self.files = [self.files[i] for i in keep]
        self._counts = [self._counts[i] for i in keep]
        if not self.files:
            raise ValueError(f"offline data at {pattern!r} is empty")
        self.max_cached_shards = max(1, int(max_cached_shards))
        self._rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self._shard_order: List[int] = list(range(len(self.files)))
        if shuffle:
            self._rng.shuffle(self._shard_order)
        self._next_shard = 0
        # working set: shard_ix -> (decoded fragments, remaining order)
        self._open: Dict[int, Any] = {}

    def __len__(self) -> int:
        return int(sum(self._counts))

    def _load_shard(self, ix: int) -> List[Dict[str, Any]]:
        frags: List[Dict[str, Any]] = []
        with open(self.files[ix], encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    row = json.loads(line)
                    frags.append(
                        {k: _decode(v) for k, v in row.items()})
        return frags

    def _refill(self) -> None:
        while len(self._open) < min(self.max_cached_shards,
                                    len(self.files)):
            if self._next_shard >= len(self._shard_order):
                self._next_shard = 0
                if self.shuffle:
                    self._rng.shuffle(self._shard_order)
            ix = self._shard_order[self._next_shard]
            self._next_shard += 1
            if ix in self._open:
                # tiny datasets: every shard already open
                break
            order = list(range(self._counts[ix]))
            if self.shuffle:
                self._rng.shuffle(order)
            else:
                order.reverse()  # pop() from the end -> forward order
            self._open[ix] = (self._load_shard(ix), order)

    def next(self) -> Dict[str, Any]:
        self._refill()
        if self.shuffle:
            # weight by remaining fragments so every fragment in the
            # working set is equally likely
            keys = list(self._open)
            weights = np.asarray(
                [len(self._open[k][1]) for k in keys], np.float64)
            ix = keys[int(self._rng.choice(
                len(keys), p=weights / weights.sum()))]
        else:
            ix = next(iter(self._open))
        frags, order = self._open[ix]
        frag = frags[order.pop()]
        if not order:
            del self._open[ix]
        return dict(frag)
