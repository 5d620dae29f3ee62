"""ReplayWriter: runner-side push client for the replay plane.

reference parity: rllib/algorithms/apex_dqn/apex_dqn.py pushes whole
SampleBatches through `ReplayActor.add.remote(batch)` round-robin,
re-pickling every fragment through actor-arg serialization. Here the
fragment goes through the scatter-put envelope once (`ray_tpu_torch.put`) and
only the ObjectRef rides the RPC — the shard maps the columns out of
shared memory zero-copy (visible as flat `ray_tpu_transport_*` counters,
not per-push copies). Routing is a stable crc32 hash (python `hash()`
is salted per process and would break routing determinism), and pushes
are bounded per shard: when a shard's inflight window is full the
fragment is shed and counted rather than queueing unboundedly behind a
slow or dying shard.
"""

from __future__ import annotations

import weakref
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import ray_tpu_torch

_WRITERS: "weakref.WeakSet[ReplayWriter]" = weakref.WeakSet()
_SAMPLER_REGISTERED = False


def route_shard(key: str, num_shards: int) -> int:
    """Deterministic fragment→shard routing (stable across processes)."""
    return zlib.crc32(key.encode()) % max(1, num_shards)


def _ensure_inflight_sampler() -> None:
    """One process-wide gauge sampler covering every live writer (the
    serve/_telemetry WeakSet pattern)."""
    global _SAMPLER_REGISTERED
    if _SAMPLER_REGISTERED:
        return
    _SAMPLER_REGISTERED = True
    from ray_tpu_torch._private import metrics_plane
    from ray_tpu_torch.util.metrics import Gauge, get_or_create
    gauge = get_or_create(
        Gauge, "ray_tpu_replay_push_inflight",
        description="replay writer: un-acked pushes per shard",
        tag_keys=("shard",))

    def _sample():
        totals: Dict[str, int] = {}
        for w in list(_WRITERS):
            for sid, dq in w._inflight.items():
                totals[str(sid)] = totals.get(str(sid), 0) + len(dq)
        for sid, n in totals.items():
            gauge.set(float(n), tags={"shard": sid})

    metrics_plane.register_sampler("replay_push_inflight", _sample)


class ReplayWriter:
    """Pushes transition batches from one env runner to the shard set.

    `shards` is a list of (shard_id, ActorHandle) pairs (handles are
    picklable, so the driver ships them inside the writer spec). The
    inflight window is reaped opportunistically on every push; a push
    that would exceed `max_inflight_per_shard` is shed — backpressure
    surfaces as `ray_tpu_replay_push_shed_total{shard}` instead of an
    unbounded driver-side queue.
    """

    def __init__(self, shards: Sequence[Tuple[int, Any]],
                 max_inflight_per_shard: int = 4):
        self._shards: List[Tuple[int, Any]] = list(shards)
        self._max_inflight = int(max_inflight_per_shard)
        self._inflight: Dict[int, deque] = {
            sid: deque() for sid, _ in self._shards}
        self._seq = 0
        self.pushes = 0
        self.shed = 0
        self.push_errors = 0
        from ray_tpu_torch.util.metrics import Counter, get_or_create
        self._shed_metric = get_or_create(
            Counter, "ray_tpu_replay_push_shed_total",
            description="replay writer: pushes shed by backpressure",
            tag_keys=("shard",))
        _WRITERS.add(self)
        _ensure_inflight_sampler()

    def set_shards(self, shards: Sequence[Tuple[int, Any]]) -> None:
        """Swap in fresh handles after a reshard; inflight refs against
        replaced shards are dropped (the acks would error anyway)."""
        new = {sid: h for sid, h in shards}
        for sid, _ in self._shards:
            if sid not in new:
                self._inflight.pop(sid, None)
        self._shards = list(shards)
        for sid, _ in self._shards:
            self._inflight.setdefault(sid, deque())

    def _reap(self, sid: int) -> None:
        dq = self._inflight[sid]
        if not dq:
            return
        ready, _ = ray_tpu_torch.wait(list(dq), num_returns=len(dq),
                                timeout=0)
        for ref in ready:
            dq.remove(ref)
            try:
                ray_tpu_torch.get(ref)  # graftlint: disable=RT002
            except Exception:
                self.push_errors += 1

    def push(self, batch: Dict[str, np.ndarray],
             priorities: Optional[np.ndarray] = None,
             route_key: Optional[str] = None) -> Optional[int]:
        """Route one column batch to its shard. Returns the shard id the
        batch went to, or None if it was shed."""
        if not self._shards:
            return None
        if route_key is None:
            route_key = str(self._seq)
        self._seq += 1
        pos = route_shard(route_key, len(self._shards))
        sid, handle = self._shards[pos]
        self._reap(sid)
        dq = self._inflight[sid]
        if len(dq) >= self._max_inflight:
            self.shed += 1
            self._shed_metric.inc(1, tags={"shard": str(sid)})
            return None
        # scatter-put the payload once; the shard resolves the top-level
        # ref from the store — the batch never re-pickles through args
        ref = ray_tpu_torch.put(batch)
        dq.append(handle.push.remote(ref, priorities))
        self.pushes += 1
        return sid

    def flush(self, timeout: float = 10.0) -> None:
        """Block until all inflight pushes ack (bench/test teardown)."""
        refs = [r for dq in self._inflight.values() for r in dq]
        if refs:
            ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=timeout)
        for sid in list(self._inflight):
            self._reap(sid)

    def stats(self) -> Dict[str, int]:
        return {
            "pushes": self.pushes,
            "shed": self.shed,
            "push_errors": self.push_errors,
            "inflight": sum(len(d) for d in self._inflight.values()),
        }
