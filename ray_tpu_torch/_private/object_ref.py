"""ObjectRef: a distributed future with ownership metadata.

reference parity: ObjectRef in python/ray/includes/object_ref.pxi — carries
the object id plus the owner's address so any holder can resolve the value,
and participates in reference counting via __del__.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID

# Active nested-ref collector for the current thread's serialization
# (reference: the SerializationContext tracks "contained object refs" so
# the submitter pins refs nested anywhere inside task args, not just
# top-level ones).
_collect_ctx = threading.local()


@contextlib.contextmanager
def collect_serialized_refs(out: list):
    prev = getattr(_collect_ctx, "refs", None)
    _collect_ctx.refs = out
    try:
        yield out
    finally:
        _collect_ctx.refs = prev


class ObjectRef:
    __slots__ = ("_id", "_owner_address", "_registered", "_cw_epoch",
                 "__weakref__")

    def __init__(self, object_id: ObjectID,
                 owner_address: Optional[Tuple[str, int]] = None,
                 _register: bool = True):
        self._id = object_id
        self._owner_address = tuple(owner_address) if owner_address else None
        self._registered = False
        self._cw_epoch = None
        if _register:
            from ray_tpu_torch._private import worker as worker_mod
            w = worker_mod.global_worker_or_none()
            if w is not None:
                w.core_worker.add_local_ref(self)
                self._registered = True
                # the release must reach the CoreWorker INSTANCE that
                # counted the add: after a shutdown+reinit, a stale ref
                # GC'd late would otherwise double-release against the
                # NEW worker's reference table (the ownership state
                # machine rejects that as an illegal transition).
                # Compared by EPOCH, not a weakref: a ref dying inside
                # a garbage cycle has its weakrefs cleared before
                # __del__ runs, which silently skipped the release.
                self._cw_epoch = w.core_worker.epoch

    @property
    def id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    def task_id(self):
        return self._id.task_id()

    @property
    def owner_address(self) -> Optional[Tuple[str, int]]:
        return self._owner_address

    def __hash__(self) -> int:
        return hash(self._id)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self) -> str:
        return f"ObjectRef({self._id.hex()})"

    def __del__(self) -> None:
        if self._registered:
            try:
                from ray_tpu_torch._private import worker as worker_mod
                w = worker_mod.global_worker_or_none()
                if w is not None and \
                        w.core_worker.epoch == self._cw_epoch:
                    w.core_worker.remove_local_ref(self)
            except Exception:  # noqa: BLE001 - interpreter shutdown
                pass

    def __reduce__(self):
        # Serialized refs re-register on the receiving process; the sender's
        # core worker pins the object for in-flight arg refs separately.
        collector = getattr(_collect_ctx, "refs", None)
        if collector is not None:
            collector.append(self)
        return (_deserialize_ref, (self._id, self._owner_address))

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from ray_tpu_torch._private import worker as worker_mod
        import concurrent.futures
        fut: concurrent.futures.Future = concurrent.futures.Future()
        w = worker_mod.global_worker()

        def _wait() -> None:
            try:
                fut.set_result(w.core_worker.get([self], timeout=None)[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        import threading
        threading.Thread(target=_wait, daemon=True).start()
        return fut


def _deserialize_ref(object_id: ObjectID,
                     owner_address: Optional[Tuple[str, int]]) -> ObjectRef:
    return ObjectRef(object_id, owner_address)


class ObjectRefGenerator:
    """Iterator over a streaming generator task's child refs, yielding
    each as it is produced (reference StreamingObjectRefGenerator,
    _raylet.pyx:269). Iterable only in the owner process (the one that
    submitted the task); the handle ref still resolves to the full list
    for batch consumers."""

    def __init__(self, handle_ref: ObjectRef):
        self._handle = handle_ref
        self._task_hex = handle_ref.task_id().hex()
        self._i = 0

    @property
    def handle(self) -> ObjectRef:
        return self._handle

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        from ray_tpu_torch._private import worker as worker_mod
        cw = worker_mod.global_worker().core_worker
        entry = cw.tasks.get(self._task_hex)
        if entry is None:
            raise RuntimeError(
                "ObjectRefGenerator can only iterate in the process that "
                "submitted the task")
        # children are keyed by return index (2-based: index 1 is the
        # handle); iterate strictly in index order so a dropped or
        # re-ordered incremental report can't skip/duplicate a child
        want = self._i + 2
        while True:
            with cw._lock:
                child = entry.dynamic_arrived.get(want)
                if child is not None:
                    self._i += 1
                    return ObjectRef(child, cw.address)
                if entry.done:
                    break
                # events are lazy (the owner holds an entry per queued
                # task; most tasks never have a streaming iterator) —
                # the first waiter creates one under the owner's lock.
                # Completion paths set it only when present, so the 1s
                # wait timeout below bounds the missed-wakeup window of
                # a setter that read None just before this create.
                if entry.dynamic_event is None:
                    entry.dynamic_event = threading.Event()
                entry.dynamic_event.clear()
            entry.dynamic_event.wait(timeout=1.0)
        # task over: surface any error via the handle, else serve any
        # child whose incremental report was lost from the final batch
        # (position i in the list IS index i+2 by construction)
        remaining = cw.get([self._handle], timeout=60)[0]
        if self._i < len(remaining):
            ref = remaining[self._i]
            self._i += 1
            return ref
        raise StopIteration
