"""Fault-tolerant actor pool with async in-flight requests + health probing.

reference parity: python/ray/rllib/utils/actor_manager.py:193
(FaultTolerantActorManager) — the generic async actor-pool used by RLlib's
WorkerSet and LearnerGroup: fan out calls, tolerate actor failures by
marking actors unhealthy, keep sampling from the healthy subset, and
periodically probe/restore the unhealthy ones (probe_unhealthy_actors,
actor_manager.py:781).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc


@dataclass
class CallResult:
    actor_id: int              # manager-local index, stable across restarts
    ok: bool
    value: Any = None          # result when ok, exception when not
    tag: Any = None


def _is_actor_failure(e: BaseException) -> bool:
    """Only actor-death-shaped errors demote an actor to unhealthy; an
    application-level exception (a bad input raising ValueError) must not
    silently shrink the pool (reference actor_manager.py marks unhealthy
    only on RayActorError)."""
    return isinstance(e, (exc.RayActorError, exc.WorkerCrashedError,
                          exc.OwnerDiedError, exc.RaySystemError))


class FaultTolerantActorManager:
    """Manages a set of actor handles with per-actor health state.

    `foreach_actor` fans a call out to healthy actors and returns
    `CallResult`s instead of raising: an actor failure marks it unhealthy
    and yields ok=False for that actor only. `foreach_actor_async` +
    `fetch_ready_async_reqs` give the IMPALA-style async pipeline with a
    bounded number of in-flight calls per actor.
    """

    def __init__(self, actors: Optional[Sequence[Any]] = None, *,
                 max_remote_requests_in_flight_per_actor: int = 2,
                 health_probe_method: str = "ping"):
        self._lock = threading.Lock()
        self._actors: Dict[int, Any] = {}
        self._healthy: Dict[int, bool] = {}
        self._next_id = 0
        self._max_in_flight = max_remote_requests_in_flight_per_actor
        self._health_probe_method = health_probe_method
        # in-flight: ref -> (actor_id, tag)
        self._in_flight: Dict[Any, Tuple[int, Any]] = {}
        for a in (actors or []):
            self.add_actor(a)

    # -- membership --------------------------------------------------------

    def add_actor(self, actor: Any) -> int:
        with self._lock:
            aid = self._next_id
            self._next_id += 1
            self._actors[aid] = actor
            self._healthy[aid] = True
            return aid

    def remove_actor(self, actor_id: int) -> None:
        with self._lock:
            self._actors.pop(actor_id, None)
            self._healthy.pop(actor_id, None)
            self._in_flight = {r: (i, t) for r, (i, t)
                               in self._in_flight.items() if i != actor_id}

    def actors(self) -> Dict[int, Any]:
        with self._lock:
            return dict(self._actors)

    def num_actors(self) -> int:
        with self._lock:
            return len(self._actors)

    def num_healthy_actors(self) -> int:
        with self._lock:
            return sum(1 for h in self._healthy.values() if h)

    def healthy_actor_ids(self) -> List[int]:
        with self._lock:
            return [i for i, h in self._healthy.items() if h]

    def is_actor_healthy(self, actor_id: int) -> bool:
        with self._lock:
            return self._healthy.get(actor_id, False)

    def set_actor_state(self, actor_id: int, healthy: bool) -> None:
        with self._lock:
            if actor_id in self._healthy:
                self._healthy[actor_id] = healthy

    # -- sync fan-out ------------------------------------------------------

    def _call(self, actor: Any, fn: Any) -> Any:
        """Submit fn to one actor; fn is a method name (str, called with no
        args), a (method, args, kwargs) tuple, or a callable applied via the
        actor's `apply` method if it has one."""
        if isinstance(fn, str):
            return getattr(actor, fn).remote()
        if isinstance(fn, tuple):
            method, args, kwargs = fn
            return getattr(actor, method).remote(*args, **(kwargs or {}))
        return actor.apply.remote(fn)

    def foreach_actor(self, fn: Any, *, healthy_only: bool = True,
                      remote_actor_ids: Optional[Sequence[int]] = None,
                      timeout_seconds: Optional[float] = 60.0
                      ) -> List[CallResult]:
        with self._lock:
            targets = [(i, a) for i, a in self._actors.items()
                       if (not healthy_only or self._healthy.get(i))
                       and (remote_actor_ids is None or i in remote_actor_ids)]
        refs = []
        for i, a in targets:
            try:
                refs.append((i, self._call(a, fn)))
            except Exception as e:  # noqa: BLE001 - submission itself failed
                if _is_actor_failure(e):
                    self.set_actor_state(i, False)
                refs.append((i, e))
        # Resolve the whole fan-out in parallel: one wait bounds it by
        # timeout_seconds TOTAL instead of timeout per actor (found by
        # graftlint RT002), while the per-ref gets below keep per-actor
        # failure isolation.
        real = [r for _, r in refs if not isinstance(r, Exception)]
        ready_set = set()
        if real:
            ready, _ = ray_tpu_torch.wait(real, num_returns=len(real),
                                    timeout=timeout_seconds)
            ready_set = set(ready)
        out: List[CallResult] = []
        for i, ref in refs:
            if isinstance(ref, Exception):
                out.append(CallResult(i, False, ref))
                continue
            if ref not in ready_set:
                out.append(CallResult(i, False, exc.GetTimeoutError(
                    f"actor {i} did not answer within "
                    f"{timeout_seconds}s")))
                continue
            try:
                # ready refs resolve instantly # graftlint: disable=RT002
                out.append(CallResult(i, True, ray_tpu_torch.get(ref)))
            except Exception as e:  # noqa: BLE001
                if _is_actor_failure(e):
                    self.set_actor_state(i, False)
                out.append(CallResult(i, False, e))
        return out

    # -- async pipeline ----------------------------------------------------

    def foreach_actor_async(self, fn: Any, *, tag: Any = None,
                            healthy_only: bool = True) -> int:
        """Fire fn at every (healthy) actor with in-flight budget left;
        returns the number of calls actually submitted."""
        submitted = 0
        with self._lock:
            targets = [(i, a) for i, a in self._actors.items()
                       if not healthy_only or self._healthy.get(i)]
            in_flight_by_actor: Dict[int, int] = {}
            for _, (i, _t) in self._in_flight.items():
                in_flight_by_actor[i] = in_flight_by_actor.get(i, 0) + 1
        for i, a in targets:
            if in_flight_by_actor.get(i, 0) >= self._max_in_flight:
                continue
            try:
                ref = self._call(a, fn)
            except Exception as e:  # noqa: BLE001
                if _is_actor_failure(e):
                    self.set_actor_state(i, False)
                continue
            with self._lock:
                self._in_flight[ref] = (i, tag)
            submitted += 1
        return submitted

    def fetch_ready_async_reqs(self, *, timeout_seconds: float = 0.1
                               ) -> List[CallResult]:
        with self._lock:
            refs = list(self._in_flight.keys())
        if not refs:
            return []
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                timeout=timeout_seconds)
        claimed: List[Tuple[Any, int, Any]] = []
        for ref in ready:
            with self._lock:
                meta = self._in_flight.pop(ref, None)
            if meta is not None:
                claimed.append((ref, meta[0], meta[1]))
        if not claimed:
            return []
        # One batched get for the whole ready set (a single store_wait
        # RPC for local results) — the per-ref path below only runs when
        # some result is an error, to keep per-actor failure isolation.
        try:
            values = ray_tpu_torch.get([ref for ref, _, _ in claimed])
            return [CallResult(i, True, v, tag)
                    for (_, i, tag), v in zip(claimed, values)]
        except Exception:  # noqa: BLE001 - isolate the failing actor(s)
            pass
        out: List[CallResult] = []
        for ref, i, tag in claimed:
            try:
                # ready refs resolve instantly # graftlint: disable=RT002
                out.append(CallResult(i, True, ray_tpu_torch.get(ref), tag))
            except Exception as e:  # noqa: BLE001
                if _is_actor_failure(e):
                    self.set_actor_state(i, False)
                out.append(CallResult(i, False, e, tag))
        return out

    def num_in_flight_async_reqs(self) -> int:
        with self._lock:
            return len(self._in_flight)

    # -- health ------------------------------------------------------------

    def probe_unhealthy_actors(self, *, timeout_seconds: float = 10.0,
                               mark_healthy: bool = True) -> List[int]:
        """Probe unhealthy actors; return ids of those that responded (a
        restarted actor answering its probe is marked healthy again)."""
        with self._lock:
            unhealthy = [(i, a) for i, a in self._actors.items()
                         if not self._healthy.get(i)]
        # Probe every unhealthy actor concurrently: submitting + getting
        # one probe at a time cost timeout_seconds per dead actor (found
        # by graftlint RT002).
        probes: List[Tuple[int, Any]] = []
        for i, a in unhealthy:
            try:
                probes.append(
                    (i, getattr(a, self._health_probe_method).remote()))
            except Exception:  # noqa: BLE001 - still dead
                continue
        refs = [r for _, r in probes]
        ready_set: set = set()
        if refs:
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                    timeout=timeout_seconds)
            ready_set = set(ready)
        restored: List[int] = []
        for i, ref in probes:
            if ref not in ready_set:
                continue
            try:
                # ready refs resolve instantly # graftlint: disable=RT002
                ray_tpu_torch.get(ref)
            except Exception:  # noqa: BLE001 - probe answered with error
                continue
            restored.append(i)
            if mark_healthy:
                self.set_actor_state(i, True)
        return restored

    def clear(self) -> None:
        with self._lock:
            actors = list(self._actors.values())
            self._actors.clear()
            self._healthy.clear()
            self._in_flight.clear()
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001 - actor already dead
                pass
