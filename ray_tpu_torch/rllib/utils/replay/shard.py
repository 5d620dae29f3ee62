"""ReplayShardActor: one shard of the distributed replay plane.

reference parity: rllib/algorithms/apex_dqn/apex_dqn.py ReplayActor —
a plain actor wrapping one (Prioritized)ReplayBuffer. Differences that
matter here: sampled batches carry (batch_indexes, item_epochs) tickets
so late priority updates for recycled slots are dropped instead of
re-prioritizing an unrelated transition, and every op is metered
(`ray_tpu_replay_*_total{shard}`) and spanned (`replay.push/sample/
update`) so the merged timeline and the `replay_shard_stall` watchdog
probe see the shard from day one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch._private import spans as _spans
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                ReplayBuffer)

REPLAY_NAMESPACE = "_replay"


def shard_actor_name(group: str, shard_id: int, generation: int) -> str:
    """Named-actor key for one shard generation; the generation bumps on
    every elastic replacement so a dead shard's registry entry never
    collides with its successor."""
    return f"RAY_TPU_REPLAY_SHARD:{group}:{shard_id}:{generation}"


def _shard_metrics():
    from ray_tpu_torch.util.metrics import Counter, get_or_create
    mk = {}
    for op in ("added", "sampled", "evicted", "priority_updates",
               "unmatched_priority_updates"):
        mk[op] = get_or_create(
            Counter, f"ray_tpu_replay_{op}_total",
            description=f"replay plane: {op.replace('_', ' ')} per shard",
            tag_keys=("shard",))
    return mk


class ReplayShardActor:
    """One bounded replay shard with local priorities.

    Runs as a plain actor; the plain (uniform) and prioritized
    (sum-tree) variants share this class — `prioritized` picks the
    buffer. Pushes arrive as already-resolved store values: the writer
    passes a top-level ObjectRef so the payload rides the scatter-put
    envelope into the shared store once and is mapped here zero-copy,
    never re-pickled through actor args (core_worker arg resolution).
    """

    def __init__(self, shard_id: int, capacity: int, *,
                 prioritized: bool = True, alpha: float = 0.6,
                 seed: Optional[int] = None, group: str = "default"):
        self.shard_id = int(shard_id)
        self.group = group
        shard_seed = None if seed is None else seed + shard_id * 7919
        if prioritized:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                capacity, alpha=alpha, seed=shard_seed)
        else:
            self.buffer = ReplayBuffer(capacity, seed=shard_seed)
        self.prioritized = prioritized
        self._tags = {"shard": str(self.shard_id)}
        self._metrics = _shard_metrics()
        self._evicted_seen = 0
        self._push_rpcs = 0
        self._sample_rpcs = 0
        self._update_rpcs = 0
        self._sampled_items = 0
        # occupancy rides the harvest as a register_sampler gauge (like
        # serve/_telemetry): point-in-time, no hot-path instrumentation
        from ray_tpu_torch._private import metrics_plane
        from ray_tpu_torch.util.metrics import Gauge, get_or_create
        occupancy = get_or_create(
            Gauge, "ray_tpu_replay_occupancy",
            description="replay shard: filled slots", tag_keys=("shard",))

        def _sample_gauges(buf=self.buffer, tags=dict(self._tags)):
            occupancy.set(float(len(buf)), tags=tags)

        metrics_plane.register_sampler(
            f"replay_shard_{group}_{shard_id}", _sample_gauges)

    def ping(self) -> str:
        """Health probe (FaultTolerantActorManager contract)."""
        return "pong"

    # ---- write path --------------------------------------------------
    def push(self, batch: Dict[str, np.ndarray],
             priorities: Optional[np.ndarray] = None) -> Dict[str, int]:
        """Append a transition column batch; `priorities` optionally
        seeds the new slots (APEX worker-computed initial priorities),
        else new items get max priority (Schaul init)."""
        n = len(next(iter(batch.values())))
        with _spans.span("replay.push", shard=self.shard_id, n=n):
            if priorities is not None and self.prioritized:
                # slots the ring is about to write, before add() moves
                # the cursor — lets the explicit priorities overwrite
                # the max-priority default right after insert
                m = min(n, self.buffer.capacity)
                idx = (self.buffer._next + np.arange(m)) \
                    % self.buffer.capacity
                self.buffer.add(batch)
                self.buffer.update_priorities(
                    idx, np.asarray(priorities)[-m:])
            else:
                self.buffer.add(batch)
        self._push_rpcs += 1
        self._metrics["added"].inc(n, tags=self._tags)
        ev = self.buffer._evicted - self._evicted_seen
        if ev:
            self._metrics["evicted"].inc(ev, tags=self._tags)
            self._evicted_seen = self.buffer._evicted
        return {"added": n, "size": len(self.buffer)}

    # ---- read path ---------------------------------------------------
    def sample(self, num_items: int, beta: float = 0.4,
               min_size: int = 1) -> Optional[Dict[str, np.ndarray]]:
        """One sample batch with (batch_indexes, item_epochs) tickets
        and IS weights, or None while the shard holds fewer than
        max(num_items, min_size) items (learning-starts gate)."""
        self._sample_rpcs += 1
        if len(self.buffer) < max(num_items, min_size):
            return None
        with _spans.span("replay.sample", shard=self.shard_id,
                         n=num_items):
            if self.prioritized:
                out = self.buffer.sample(num_items, beta=beta)
            else:
                out = self.buffer.sample(num_items)
        self._sampled_items += num_items
        self._metrics["sampled"].inc(num_items, tags=self._tags)
        return out

    # ---- priority feedback (one-way from the learner) ----------------
    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray,
                          epochs: Optional[np.ndarray] = None) -> int:
        """Apply TD-error priorities for previously sampled tickets;
        stale tickets (slot recycled since the sample) are dropped and
        counted. Returns the number applied."""
        self._update_rpcs += 1
        if not self.prioritized:
            return 0
        with _spans.span("replay.update", shard=self.shard_id,
                         n=len(np.asarray(idx))):
            before = self.buffer.unmatched_priority_updates
            applied = self.buffer.update_priorities(
                idx, priorities, epochs=epochs)
            unmatched = self.buffer.unmatched_priority_updates - before
        if applied:
            self._metrics["priority_updates"].inc(applied,
                                                  tags=self._tags)
        if unmatched:
            self._metrics["unmatched_priority_updates"].inc(
                unmatched, tags=self._tags)
        return applied

    # ---- introspection (state surface / CLI / dashboard) -------------
    def stats(self) -> Dict[str, Any]:
        return {
            "shard_id": self.shard_id,
            "group": self.group,
            "prioritized": self.prioritized,
            "size": len(self.buffer),
            "capacity": self.buffer.capacity,
            "added": self.buffer.num_added,
            "evicted": self.buffer._evicted,
            "sampled": self._sampled_items,
            "push_rpcs": self._push_rpcs,
            "sample_rpcs": self._sample_rpcs,
            "update_rpcs": self._update_rpcs,
            "unmatched_priority_updates":
                self.buffer.unmatched_priority_updates,
            "max_priority": getattr(self.buffer, "_max_priority", None),
        }
