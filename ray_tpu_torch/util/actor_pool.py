"""ActorPool: map work over a fixed set of actors.

reference parity: python/ray/util/actor_pool.py — submit(fn, value) /
get_next() / get_next_unordered() / map() / map_unordered() over a pool,
keeping every actor busy with at most one in-flight item each and
handing free actors the next pending value.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle: List[Any] = list(actors)
        self._in_flight: dict = {}          # ref -> actor
        self._pending: List[tuple] = []     # (fn, value)
        self._order: List[Any] = []         # submission-ordered refs

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef (e.g. lambda a, v:
        a.work.remote(v))."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._in_flight[ref] = actor
            self._order.append(ref)
        else:
            self._pending.append((fn, value))

    def _reclaim(self, ref: Any) -> None:
        actor = self._in_flight.pop(ref)
        if self._pending:
            fn, value = self._pending.pop(0)
            nxt = fn(actor, value)
            self._in_flight[nxt] = actor
            self._order.append(nxt)
        else:
            self._idle.append(actor)

    def has_next(self) -> bool:
        return bool(self._order)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in SUBMISSION order. On timeout the result stays
        retrievable and the actor stays tracked; on a task error the
        actor still returns to the pool (the error re-raises)."""
        if not self._order:
            raise StopIteration("no pending results")
        ref = self._order[0]
        try:
            value = ray_tpu_torch.get(ref, timeout=timeout)
        except ray_tpu_torch.exceptions.GetTimeoutError:
            raise  # nothing consumed; call again later
        except Exception:
            self._order.pop(0)
            self._reclaim(ref)
            raise
        self._order.pop(0)
        self._reclaim(ref)
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Whichever pending result finishes first."""
        if not self._order:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._in_flight),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        self._order.remove(ref)
        try:
            value = ray_tpu_torch.get(ref)
        except Exception:
            self._reclaim(ref)  # failed task must not strand its actor
            raise
        self._reclaim(ref)
        return value

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self) -> Any:
        return self._idle.pop() if self._idle else None

    def push(self, actor: Any) -> None:
        self._idle.append(actor)
