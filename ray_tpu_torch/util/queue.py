"""Distributed FIFO queue backed by an actor.

reference parity: python/ray/util/queue.py — Queue wraps a _QueueActor
with put/get (blocking with timeout), qsize/empty/full, put_nowait/
get_nowait and batch variants; usable from any process in the cluster
(pass the Queue object into tasks/actors).
"""

from __future__ import annotations

from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    """The server side. Blocking semantics are implemented with
    condition variables inside the actor (it runs with max_concurrency
    so parked gets don't stall puts)."""

    def __init__(self, maxsize: int):
        import collections
        import threading
        self._maxsize = maxsize
        self._items: "collections.deque" = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    def qsize(self) -> int:
        with self._lock:
            return len(self._items)

    def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        with self._not_full:
            if self._maxsize > 0:
                if not self._not_full.wait_for(
                        lambda: len(self._items) < self._maxsize,
                        timeout=timeout):
                    return False
            self._items.append(item)
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        with self._not_empty:
            if not self._not_empty.wait_for(lambda: self._items,
                                            timeout=timeout):
                return (False, None)
            item = self._items.popleft()
            self._not_full.notify()
            return (True, item)

    def put_batch(self, items: List[Any],
                  timeout: Optional[float] = None) -> bool:
        """All-or-nothing: waits for capacity for the WHOLE batch, so a
        timeout never leaves a partial insertion for the client to
        retry-and-duplicate. A batch larger than maxsize can never fit."""
        with self._not_full:
            if self._maxsize > 0:
                need = len(items)
                if need > self._maxsize:
                    return False
                if not self._not_full.wait_for(
                        lambda: self._maxsize - len(self._items) >= need,
                        timeout=timeout):
                    return False
            self._items.extend(items)
            self._not_empty.notify_all()
            return True

    def get_batch(self, max_items: int) -> List[Any]:
        with self._lock:
            out = []
            while self._items and len(out) < max_items:
                out.append(self._items.popleft())
            self._not_full.notify_all()
            return out


class Queue:
    """Client handle; picklable (travels into tasks/actors)."""

    def __init__(self, maxsize: int = 0, *, _actor: Any = None):
        self.maxsize = maxsize
        if _actor is not None:
            self._actor = _actor
            return
        cls = ray_tpu_torch.remote(_QueueActor)
        # parked blocking gets/puts each occupy an executor thread
        self._actor = cls.options(num_cpus=0,
                                  max_concurrency=16).remote(maxsize)

    def __reduce__(self):
        # ship the handle, not a fresh queue: all holders share the actor
        return (_rebuild_queue, (self.maxsize, self._actor))

    # Blocking calls loop over SHORT server-side waits (≤ this slice):
    # a call that parked indefinitely would pin one of the actor's
    # max_concurrency executor threads — with all threads parked, the
    # put that would wake them could never run (hard deadlock).
    _WAIT_SLICE_S = 0.5

    def _blocking_loop(self, submit, block: bool,
                       timeout: Optional[float]):
        import time
        if not block:
            return ray_tpu_torch.get(submit(0.0))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                # blocking-queue emulation: ONE server-parked call per
                # wait slice by design # graftlint: disable=RT002
                return ray_tpu_torch.get(submit(0.0))
            wait = self._WAIT_SLICE_S if remaining is None \
                else min(self._WAIT_SLICE_S, remaining)
            result = ray_tpu_torch.get(submit(wait))  # graftlint: disable=RT002
            ok = result[0] if isinstance(result, tuple) else result
            if ok:
                return result

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        ok = self._blocking_loop(
            lambda t: self._actor.put.remote(item, timeout=t),
            block, timeout)
        if not ok:
            raise Full("queue full")

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        ok, item = self._blocking_loop(
            lambda t: self._actor.get.remote(timeout=t), block, timeout)
        if not ok:
            raise Empty("queue empty")
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_batch(self, items: List[Any],
                  timeout: Optional[float] = None) -> None:
        items = list(items)
        if self.maxsize > 0 and len(items) > self.maxsize:
            raise Full(f"batch of {len(items)} can never fit "
                       f"maxsize={self.maxsize}")
        ok = self._blocking_loop(
            lambda t: self._actor.put_batch.remote(items, timeout=t),
            True, timeout)
        if not ok:
            raise Full("queue full")

    def get_batch(self, max_items: int) -> List[Any]:
        return ray_tpu_torch.get(self._actor.get_batch.remote(max_items))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:  # noqa: BLE001 - queue actor already dead
            pass


def _rebuild_queue(maxsize: int, actor: Any) -> Queue:
    return Queue(maxsize, _actor=actor)
