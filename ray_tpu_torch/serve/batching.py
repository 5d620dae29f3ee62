"""@serve.batch: transparent request batching inside replicas.

reference parity: python/ray/serve/batching.py — a decorated method
receives a LIST of requests and returns a LIST of results; concurrent
callers are coalesced up to max_batch_size, waiting at most
batch_wait_timeout_s for stragglers. TPU-first motivation: the MXU wants
batched inference, so the router's individual requests must fuse into
one forward pass at the replica. Thread-based here (replica actors run
handle_request on max_concurrent_queries exec threads).
"""

from __future__ import annotations

import functools
import queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Tuple


# per-process; replicas resolve it by module import, so it never pickles
_INIT_LOCK = threading.Lock()


class _BatchQueue:
    def __init__(self, fn: Callable, owner: Any, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._owner = owner
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._q: "queue.Queue[Tuple[Any, Future]]" = queue.Queue()
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name=f"serve-batch-{getattr(fn, '__name__', 'fn')}")
        self._thread.start()

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        self._q.put((item, fut))
        return fut

    def _collect(self) -> List[Tuple[Any, Future]]:
        first = self._q.get()
        batch = [first]
        import time
        deadline = time.monotonic() + self._timeout
        while len(batch) < self._max:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # deadline passed: take only what's already queued
                try:
                    batch.append(self._q.get_nowait())
                    continue
                except queue.Empty:
                    break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _worker(self) -> None:
        while True:
            batch = self._collect()
            items = [b[0] for b in batch]
            try:
                results = self._fn(self._owner, items)
                if len(results) != len(items):
                    raise ValueError(
                        f"batched function returned {len(results)} "
                        f"results for {len(items)} requests")
                for (_, fut), r in zip(batch, results):
                    fut.set_result(r)
            except Exception as e:  # noqa: BLE001
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


def batch(_func: Callable = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorate a replica method taking (self, items: List) -> List.
    Callers invoke it with a SINGLE item; concurrent calls coalesce.
    """

    def deco(fn: Callable) -> Callable:
        attr = f"__serve_batch_queue_{fn.__name__}"

        def _ensure_queue(self):
            q = getattr(self, attr, None)
            if q is None:
                # the module-level lock guards first-call queue init.
                # Resolved via import AT CALL TIME: the wrapper pickles
                # by value into replicas, and a lock captured in the
                # closure or as a global would (a) race its own
                # creation or (b) fail to pickle.
                import ray_tpu_torch.serve.batching as _mod
                with _mod._INIT_LOCK:
                    q = getattr(self, attr, None)
                    if q is None:
                        q = _mod._BatchQueue(fn, self, max_batch_size,
                                             batch_wait_timeout_s)
                        setattr(self, attr, q)
            return q

        @functools.wraps(fn)
        def wrapper(self, item: Any):
            return _ensure_queue(self).submit(item).result()

        def _submit_many(self, items: List[Any]) -> List[Future]:
            """Enqueue a proxy-coalesced batch WITHOUT blocking between
            items (every item must be in the queue before anyone waits,
            or the fused forward pass degenerates to per-item passes).
            Used by Replica.handle_request_batch; returns the futures
            in item order."""
            q = _ensure_queue(self)
            return [q.submit(i) for i in items]

        wrapper._serve_batch = True  # type: ignore[attr-defined]
        wrapper._serve_batch_submit_many = _submit_many  # type: ignore[attr-defined]
        return wrapper

    if _func is not None:
        return deco(_func)
    return deco
