"""Replay buffers: uniform ring + prioritized (sum-tree).

reference parity: rllib/utils/replay_buffers/replay_buffer.py
(ReplayBuffer: capacity in timesteps, add/sample over SampleBatch) and
prioritized_replay_buffer.py (PrioritizedReplayBuffer: proportional
prioritization per Schaul 2015 — sum-tree sampling, importance weights
with beta annealing, update_priorities). The reference stores pickled
SampleBatch objects per slot; the TPU build stores *columns* in
preallocated numpy rings so sample() is a vectorized gather producing a
jit-ready minibatch with stable shapes/dtypes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform-sampling ring buffer over column batches of transitions."""

    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        assert capacity > 0
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0          # next write slot
        self._size = 0          # filled slots
        self._added = 0         # lifetime timesteps added
        self._evicted = 0       # lifetime slots overwritten
        self._rng = np.random.default_rng(seed)
        # Per-slot write generation: bumped on every (over)write. Sampled
        # batches carry it as `item_epochs` so a priority update that
        # arrives after the slot was recycled can be detected and dropped
        # instead of silently re-prioritizing an unrelated transition.
        self._epoch = np.zeros(self.capacity, np.int64)
        self.unmatched_priority_updates = 0

    def __len__(self) -> int:
        return self._size

    @property
    def num_added(self) -> int:
        return self._added

    def _ensure_storage(self, batch: Dict[str, np.ndarray]) -> None:
        for k, v in batch.items():
            if k not in self._cols:
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity, *v.shape[1:]),
                                         v.dtype)

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        """Add a column batch of N transitions (row axis 0)."""
        batch = {k: np.asarray(v) for k, v in batch.items()
                 if not np.asarray(v).dtype.hasobject}
        n = len(next(iter(batch.values())))
        if n > self.capacity:  # keep only the newest capacity rows
            batch = {k: v[-self.capacity:] for k, v in batch.items()}
            n = self.capacity
        self._ensure_storage(batch)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = v
        self._evicted += max(0, self._size + n - self.capacity)
        self._epoch[idx] += 1
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        self._added += n
        self._on_added(idx)

    def _on_added(self, idx: np.ndarray) -> None:
        pass

    def sample(self, num_items: int) -> Dict[str, np.ndarray]:
        assert self._size > 0, "sampling from an empty buffer"
        idx = self._rng.integers(self._size, size=num_items)
        out = {k: v[idx] for k, v in self._cols.items()}
        out["batch_indexes"] = idx
        out["item_epochs"] = self._epoch[idx].copy()
        return out

    def get_state(self) -> Dict[str, np.ndarray]:
        return {"cols": {k: v[:self._size].copy()
                         for k, v in self._cols.items()},
                "next": self._next, "size": self._size,
                "added": self._added}

    def set_state(self, state) -> None:
        self._cols = {}
        self._size = 0
        self._next = 0
        if state["size"]:
            self.add(state["cols"])
        self._next = state["next"] % self.capacity
        self._added = state["added"]


class _SumTree:
    """Binary indexed sum-tree over `capacity` leaves for O(log n)
    proportional sampling and updates (reference segment_tree.py)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        size = 1
        while size < capacity:
            size *= 2
        self.size = size
        self.tree = np.zeros(2 * size, np.float64)

    def set(self, idx: np.ndarray, values: np.ndarray) -> None:
        pos = np.asarray(idx) + self.size
        self.tree[pos] = values
        pos //= 2
        while np.any(pos >= 1):
            uniq = np.unique(pos[pos >= 1])
            self.tree[uniq] = self.tree[2 * uniq] + self.tree[2 * uniq + 1]
            pos = uniq // 2

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def find(self, prefix_sums: np.ndarray) -> np.ndarray:
        """For each prefix sum, the leaf index whose cumulative range
        contains it."""
        idx = np.ones(len(prefix_sums), np.int64)
        s = np.asarray(prefix_sums, np.float64).copy()
        while idx[0] < self.size:  # all leaves at equal depth
            left = 2 * idx
            left_sum = self.tree[left]
            go_right = s > left_sum
            s = np.where(go_right, s - left_sum, s)
            idx = np.where(go_right, left + 1, left)
        return idx - self.size

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self.tree[np.asarray(idx) + self.size]


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference
    prioritized_replay_buffer.py): p_i = (|delta_i| + eps)^alpha,
    P(i) = p_i / sum_j p_j, IS weight w_i = (N * P(i))^-beta / max w."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        assert alpha > 0
        self.alpha = float(alpha)
        self._tree = _SumTree(self.capacity)
        self._max_priority = 1.0
        self._eps = 1e-6

    def _on_added(self, idx: np.ndarray) -> None:
        # new transitions get max priority so everything is seen once
        self._tree.set(idx, np.full(len(idx),
                                    self._max_priority ** self.alpha))

    def sample(self, num_items: int,
               beta: float = 0.4) -> Dict[str, np.ndarray]:
        assert self._size > 0, "sampling from an empty buffer"
        total = self._tree.total
        # stratified proportional sampling
        bounds = np.linspace(0.0, total, num_items + 1)
        targets = self._rng.uniform(bounds[:-1], bounds[1:])
        idx = self._tree.find(np.minimum(targets, total * (1 - 1e-12)))
        idx = np.minimum(idx, self._size - 1)
        probs = self._tree.get(idx) / max(total, 1e-12)
        weights = (self._size * np.maximum(probs, 1e-12)) ** (-beta)
        weights = weights / weights.max()
        out = {k: v[idx] for k, v in self._cols.items()}
        out["batch_indexes"] = idx
        out["item_epochs"] = self._epoch[idx].copy()
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray,
                          epochs: Optional[np.ndarray] = None) -> int:
        """Re-prioritize sampled slots; returns the number applied.

        `epochs` (the `item_epochs` ticket from sample()) guards against
        the APEX staleness class: an update racing an overwrite of the
        same slot would otherwise land on a different transition. Stale
        tickets are dropped and counted, never applied.
        """
        idx = np.asarray(idx)
        p = np.abs(np.asarray(priorities, np.float64)) + self._eps
        if epochs is not None:
            live = self._epoch[idx] == np.asarray(epochs)
            self.unmatched_priority_updates += int((~live).sum())
            idx, p = idx[live], p[live]
            if not len(idx):
                return 0
        self._max_priority = max(self._max_priority, float(p.max()))
        # duplicate slots in one update batch: last write wins in the
        # tree either way, but dedupe keeps set() idempotent
        self._tree.set(idx, p ** self.alpha)
        return int(len(idx))

    def get_state(self):
        state = super().get_state()
        state["priorities"] = self._tree.get(np.arange(self._size))
        state["max_priority"] = self._max_priority
        return state

    def set_state(self, state) -> None:
        super().set_state(state)
        if state["size"]:
            self._tree.set(np.arange(state["size"]),
                           state["priorities"])
        self._max_priority = state["max_priority"]
