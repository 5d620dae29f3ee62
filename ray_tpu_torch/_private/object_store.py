"""Per-node shared-memory object store (plasma equivalent).

reference parity: src/ray/object_manager/plasma/store.h (PlasmaStore),
object_lifecycle_manager.h, eviction_policy.h (LRU), plasma_allocator.h
(the dlmalloc shm arena — here ray_tpu/native/store_arena.cpp, a C++
boundary-tag allocator over ONE mmap'd arena file), plus the node-to-node
chunked transfer of src/ray/object_manager/{push,pull}_manager.h.

Design: every node manager hosts a StoreServer. Payloads live in a
shared-memory arena that every process on the node maps once; objects
are (offset, size) slices handed out by the native allocator, so client
reads are zero-copy and object creation is an allocation, not a file
create + per-object mmap. When the native toolchain is unavailable the
server falls back to the original file-per-object layout transparently
(location descriptors carry the layout: ("arena", path, offset, size) or
("file", path, size)). The server LRU-evicts unpinned sealed objects
under pressure, spills pinned primaries to disk, and serves chunked
reads so a peer store can pull objects across nodes.
"""

from __future__ import annotations

import logging
import mmap
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import chaos as chaos_lib
from ray_tpu_torch._private import ownership as _ownership
from ray_tpu_torch._private import rpc as rpc_lib
from ray_tpu_torch._private import spans as _spans
from ray_tpu_torch.util.locks import TracedLock

logger = logging.getLogger(__name__)

CHUNK_SIZE = 8 << 20  # 8 MiB transfer chunks (reference object_buffer_pool)


class ObjectStoreFullError(Exception):
    pass


@dataclass
class _Entry:
    size: int
    offset: Optional[int] = None   # arena payload offset (arena layout)
    path: Optional[str] = None     # backing file (file layout / spilled)
    sealed: bool = False
    pinned: int = 0          # pin count (owner pins while referenced)
    # reader leases (store_pin / pin=True on wait/pull): while > 0 a
    # zero-copy view of this block is outstanding, so the entry is
    # neither dropped, spilled, nor chaos-evicted (eviction defers)
    leases: int = 0
    last_access: float = field(default_factory=time.time)
    # monotonic so ages never jump with wall-clock adjustments (RT010)
    created_mono: float = field(default_factory=time.monotonic)
    creating: bool = True
    spilled: bool = False    # payload lives in the disk spill dir, not shm


class StoreServer:
    """Metadata + lifecycle authority for one node's shared-memory objects."""

    def __init__(self, session_dir: str, capacity_bytes: int,
                 host: str = "127.0.0.1",
                 spill_dir: Optional[str] = None):
        self.dir = os.path.join(session_dir, "objects")
        os.makedirs(self.dir, exist_ok=True)
        # Spill target must be real disk, not /dev/shm (spilling to RAM
        # frees nothing) — reference local_object_manager.cc:161-334 spills
        # to external storage via _private/external_storage.py.
        if spill_dir is None:
            import tempfile
            spill_dir = os.path.join(
                tempfile.gettempdir(),
                "ray_tpu_spill_" + os.path.basename(session_dir.rstrip("/")))
        self.spill_dir = spill_dir
        os.makedirs(self.spill_dir, exist_ok=True)
        self.capacity = capacity_bytes
        self.used = 0
        self.num_spilled = 0
        self.num_restored = 0
        self._objects: Dict[str, _Entry] = {}
        # chaos evictions deferred because a reader lease was live; the
        # delete fires when the last lease releases (unpin)
        self._deferred_evict: set = set()
        # arena blocks of deleted/replaced entries that still had reader
        # leases: oid -> [[offset, remaining_leases], ...]. Releasing
        # them would rewrite memory under live zero-copy views, so they
        # are held until their leases drain through unpin().
        self._orphans: Dict[str, List[List[int]]] = {}
        self._quarantine: List[Tuple[float, int]] = []  # (freed_at, offset)
        # in-flight pull dedup: oid -> Event set when the transfer ends
        # (N concurrent pulls of one object must stream it ONCE)
        self._pulls_in_flight: Dict[str, threading.Event] = {}
        self._lock = TracedLock("object_store")
        self._sealed_cv = threading.Condition(self._lock)
        self._pool = rpc_lib.ClientPool(timeout=60)

        # Native arena (reference PlasmaAllocator); None → file layout.
        self.arena = None
        self.arena_path = os.path.join(self.dir, "arena")
        try:
            from ray_tpu_torch.native import NativeArena
            self.arena = NativeArena(self.arena_path,
                                     capacity=capacity_bytes)
        except Exception as e:  # noqa: BLE001 - no toolchain: fall back
            logger.info("native arena unavailable (%s); using "
                        "file-per-object store", e)

        self.server = rpc_lib.RpcServer({
            "store_create": self.create,
            "store_seal": self.seal,
            "store_wait": self.wait,
            "store_contains": self.contains,
            "store_delete": self.delete,
            "store_pin": self.pin,
            "store_unpin": self.unpin,
            "store_read_chunk": self.read_chunk,
            "store_pull": self.pull,
            "store_put_raw": self.put_raw,
            "store_put_segments": self.put_segments,
            "store_register": self.register_sealed,
            "store_arena_info": self.arena_info,
            "store_chaos_evict": self.chaos_evict,
            "store_stats": self.stats,
            "store_list": self.list_objects,
        }, host=host)
        self.address = self.server.address

    # -- layout helpers ------------------------------------------------

    def _descriptor(self, e: _Entry) -> Tuple:
        if e.offset is not None:
            return ("arena", self.arena_path, e.offset, e.size)
        return ("file", e.path, e.size)

    def _payload_view(self, e: _Entry) -> memoryview:
        assert e.offset is not None
        return self.arena.view(e.offset, e.size)

    # -- space management ----------------------------------------------

    # Freed arena blocks sit in a time-quarantine before real reuse: a
    # reader may still hold a zero-copy view of the region (plasma solves
    # this with a client release protocol; the quarantine bounds the
    # hazard window instead). Holding the ObjectRef remains the
    # guaranteed-safe contract for long-lived zero-copy values.
    ARENA_FREE_DELAY_S = 10.0

    def _arena_release_locked(self, offset: int) -> None:
        self._quarantine.append((time.monotonic(), offset))

    def _drain_quarantine_locked(self, force: bool = False) -> None:
        now = time.monotonic()
        keep = []
        for t, off in self._quarantine:
            if force or now - t >= self.ARENA_FREE_DELAY_S:
                try:
                    self.arena.free(off)
                except ValueError:
                    pass
            else:
                keep.append((t, off))
        self._quarantine = keep

    def _eviction_order_locked(self) -> List[str]:
        """Victim order, computed ONCE per space request: LRU unpinned
        replicas first (dropped), then LRU pinned primaries (spilled).
        Leased entries are untouchable — a reader holds a zero-copy view
        of the block, so dropping OR spilling it (both release the arena
        offset) would rewrite memory under a live array."""
        unpinned = sorted(
            ((e.last_access, oid) for oid, e in self._objects.items()
             if e.sealed and e.pinned == 0 and e.leases == 0
             and not e.spilled))
        pinned = sorted(
            ((e.last_access, oid) for oid, e in self._objects.items()
             if e.sealed and e.pinned > 0 and e.leases == 0
             and not e.spilled))
        return [oid for _, oid in unpinned] + [oid for _, oid in pinned]

    def _evict_next_locked(self, order: List[str]) -> bool:
        while order:
            oid = order.pop(0)
            e = self._objects.get(oid)
            if e is None or e.spilled or not e.sealed:
                continue
            if e.pinned == 0:
                self._delete_locked(oid)
            else:
                self._spill_locked(oid)
            return True
        return False

    def _evict_until(self, needed: int,
                     order: Optional[List[str]] = None) -> None:
        """Free shm space (reference eviction_policy.h LRU +
        local_object_manager.cc:161-334 SpillObjects)."""
        if self.used + needed <= self.capacity:
            return
        if order is None:
            order = self._eviction_order_locked()
        while self.used + needed > self.capacity:
            if not self._evict_next_locked(order):
                raise ObjectStoreFullError(
                    f"object store full: need {needed}, used "
                    f"{self.used}/{self.capacity}")

    def _alloc_locked(self, size: int) -> int:
        """Arena allocation with eviction on both capacity pressure and
        fragmentation (alloc can fail below capacity when no contiguous
        block fits)."""
        self._drain_quarantine_locked()
        order = self._eviction_order_locked()
        self._evict_until(size, order)
        off = self.arena.alloc(size)
        while off == 0:
            if not self._evict_next_locked(order):
                # last resort: reclaim quarantined blocks early
                self._drain_quarantine_locked(force=True)
                off = self.arena.alloc(size)
                if off:
                    return off
                raise ObjectStoreFullError(
                    f"object store fragmented/full allocating {size} "
                    f"(used {self.used}/{self.capacity})")
            off = self.arena.alloc(size)
        return off

    def _spill_locked(self, object_id: str) -> None:
        e = self._objects.get(object_id)
        if e is None or not e.sealed or e.spilled:
            return
        spill_path = os.path.join(self.spill_dir, object_id)
        with open(spill_path, "wb") as dst:
            if e.offset is not None:
                dst.write(self._payload_view(e))
            else:
                with open(e.path, "rb") as src:
                    while True:
                        chunk = src.read(CHUNK_SIZE)
                        if not chunk:
                            break
                        dst.write(chunk)
        if e.offset is not None:
            self._arena_release_locked(e.offset)
            e.offset = None
        elif e.path:
            try:
                os.unlink(e.path)
            except OSError:
                pass
        e.path = spill_path
        e.spilled = True
        self.used -= e.size
        self.num_spilled += 1

    def _restore_locked(self, object_id: str) -> None:
        """Bring a spilled object back into shm (reference
        RestoreSpilledObject)."""
        e = self._objects.get(object_id)
        if e is None or not e.spilled:
            return
        spill_path = e.path
        if self.arena is not None:
            off = self._alloc_locked(e.size)
            with open(spill_path, "rb") as src:
                view = self.arena.view(off, e.size)
                src.readinto(view)  # type: ignore[arg-type]
            e.offset = off
            e.path = None
        else:
            self._evict_until(e.size)
            shm_path = os.path.join(self.dir, object_id)
            with open(spill_path, "rb") as src, \
                    open(shm_path, "wb") as dst:
                while True:
                    chunk = src.read(CHUNK_SIZE)
                    if not chunk:
                        break
                    dst.write(chunk)
            e.path = shm_path
        try:
            os.unlink(spill_path)
        except OSError:
            pass
        e.spilled = False
        e.last_access = time.time()
        self.used += e.size
        self.num_restored += 1

    def _delete_locked(self, object_id: str) -> None:
        e = self._objects.pop(object_id, None)
        self._deferred_evict.discard(object_id)
        if e is None:
            return
        if not e.spilled:
            self.used -= e.size
        if e.offset is not None:
            if e.leases > 0:
                # a reader still holds zero-copy views of this block
                # (owner freed before unpin, or the id was re-created):
                # orphan it until the leases drain rather than recycling
                # memory under live arrays
                self._orphans.setdefault(object_id, []).append(
                    [e.offset, e.leases])
            else:
                self._arena_release_locked(e.offset)
        elif e.path:
            try:
                os.unlink(e.path)
            except OSError:
                pass

    # -- lifecycle -------------------------------------------------------

    def create(self, object_id: str, size: int, pin: bool = True) -> Tuple:
        """Allocate backing space; returns the location descriptor.

        Primary (owner-written) copies are created pinned so LRU eviction
        can't drop an object the owner still references; delete() (driven
        by the owner's refcount) removes them. Pulled replica copies are
        created unpinned and evictable (the primary exists elsewhere).
        """
        # no dedicated span: RPC creates are visible as
        # rpc.server(store_create); fast-path client creates sit inside
        # cw.store_value — a third record would only add recorder cost
        chaos_lib.on_store_op("store_create", [object_id], self)
        with self._lock:
            if object_id in self._objects:
                e = self._objects[object_id]
                if e.size == size and not e.spilled:
                    return self._descriptor(e)
                # Same id re-created with a different payload size (lineage
                # re-execution of a nondeterministic task) or a spilled
                # entry being rewritten: replace the backing space.
                self._delete_locked(object_id)
            if self.arena is not None:
                off = self._alloc_locked(size)
                entry = _Entry(size=size, offset=off,
                               pinned=1 if pin else 0)
            else:
                self._evict_until(size)
                path = os.path.join(self.dir, object_id)
                with open(path, "wb") as f:
                    f.truncate(max(size, 1))
                entry = _Entry(size=size, path=path,
                               pinned=1 if pin else 0)
            self._objects[object_id] = entry
            self.used += size
            return self._descriptor(entry)

    def put_raw(self, object_id: str, data: bytes, pin: bool = False) -> None:
        """Create + write + seal in one RPC (remote pushes, small writers)."""
        self.create(object_id, len(data), pin=pin)
        with self._lock:
            e = self._objects.get(object_id)
            if e is not None and e.offset is not None:
                self._payload_view(e)[:len(data)] = data
            elif e is not None:
                with open(e.path, "r+b") as f:
                    f.write(data)
        self.seal(object_id)

    def put_segments(self, object_id: str, segments: List[bytes],
                     pin: bool = False) -> None:
        """Scatter variant of put_raw: the segments land back-to-back in
        one allocation without the caller ever joining them into a
        single bytes object."""
        total = sum(len(s) for s in segments)
        self.create(object_id, total, pin=pin)
        with self._lock:
            e = self._objects.get(object_id)
            if e is not None and e.offset is not None:
                view = self._payload_view(e)
                off = 0
                for s in segments:
                    view[off:off + len(s)] = s
                    off += len(s)
            elif e is not None:
                with open(e.path, "r+b") as f:
                    for s in segments:
                        f.write(s)
        self.seal(object_id)

    def seal(self, object_id: str) -> None:
        with self._sealed_cv:
            e = self._objects.get(object_id)
            if e is None:
                raise KeyError(f"seal of unknown object {object_id}")
            e.sealed = True
            e.creating = False
            e.last_access = time.time()
            self._sealed_cv.notify_all()

    def arena_info(self) -> Optional[str]:
        """Arena path for client-side fast-path allocation (None in the
        file-per-object fallback layout)."""
        return self.arena_path if self.arena is not None else None

    def register_sealed(self, object_id: str, offset: int, size: int,
                        pin: bool = True) -> None:
        """Adopt a client-allocated, already-written arena block as a
        sealed object (the scatter-write put fast path: the client
        allocs straight from the process-shared arena, writes the
        envelope, and this one-way notification replaces the
        create+seal round trips). The store_create chaos hook fires in
        the CLIENT for this path (see StoreClient.create) so error
        rules propagate to the writer and fire counts stay per-create."""
        with self._sealed_cv:
            e = self._objects.get(object_id)
            if e is not None:
                if e.offset == offset and e.size == size:
                    return  # duplicate register (oneway resend): no-op
                # re-created id (lineage re-execution): replace backing
                self._delete_locked(object_id)
            self._objects[object_id] = _Entry(
                size=size, offset=offset, pinned=1 if pin else 0,
                sealed=True, creating=False)
            self.used += size
            self._sealed_cv.notify_all()

    def wait(self, object_ids: List[str], timeout: Optional[float] = None,
             num_required: Optional[int] = None,
             pin: bool = False) -> Dict[str, Tuple]:
        """Block until objects are sealed locally; returns {id: descriptor}.
        Objects not present locally are NOT fetched here (see pull).
        pin=True takes one reader lease per returned object (release
        with unpin) so the descriptors stay valid as zero-copy views."""
        chaos_lib.on_store_op("store_wait", list(object_ids), self)
        deadline = None if timeout is None else time.monotonic() + timeout
        num_required = len(object_ids) if num_required is None else num_required
        # span only when the wait actually BLOCKED: that is the signal
        # this op exists to expose, and already-sealed lookups (the
        # trajectory-plane common case) stay recorder-free
        _t0 = _spans.begin()
        blocked = [False]
        try:
            return self._wait_impl(object_ids, deadline, num_required,
                                   pin, blocked)
        finally:
            if blocked[0]:
                _spans.end("store.wait", _t0, n=len(object_ids))

    def _wait_impl(self, object_ids: List[str],
                   deadline: Optional[float], num_required: int,
                   pin: bool, blocked: List[bool]) -> Dict[str, Tuple]:
        with self._sealed_cv:
            while True:
                ready = {}
                for oid in object_ids:
                    e = self._objects.get(oid)
                    if e is not None and e.sealed:
                        if e.spilled:
                            self._restore_locked(oid)
                        e.last_access = time.time()
                        ready[oid] = self._descriptor(e)
                if len(ready) >= num_required:
                    if pin:
                        for oid in ready:
                            _ownership.store_lease(self._objects[oid],
                                                   oid)
                    return ready
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    if pin:
                        for oid in ready:
                            _ownership.store_lease(self._objects[oid],
                                                   oid)
                    return ready
                blocked[0] = True
                self._sealed_cv.wait(timeout=min(remaining or 1.0, 1.0))

    def contains(self, object_id: str) -> bool:
        with self._lock:
            e = self._objects.get(object_id)
            return e is not None and e.sealed

    def delete(self, object_ids: List[str]) -> None:
        with self._lock:
            for oid in object_ids:
                self._delete_locked(oid)

    def chaos_evict(self, object_glob: Optional[str],
                    op_object_ids: List[str]) -> int:
        """Actuator for `evict_object` chaos rules: drop matching sealed
        objects from this store even if pinned (simulating loss of the
        primary, the case lineage reconstruction exists for). With no
        glob, the objects named in the triggering op are evicted."""
        import fnmatch as _fnmatch
        deferred = 0
        with self._lock:
            if object_glob:
                victims = [oid for oid in self._objects
                           if _fnmatch.fnmatchcase(oid, object_glob)]
            else:
                victims = [oid for oid in op_object_ids
                           if oid in self._objects]
            for oid in victims:
                e = self._objects.get(oid)
                if e is not None and e.leases > 0:
                    # a reader holds a zero-copy view: deleting now would
                    # rewrite memory under a live array. Defer the
                    # eviction to the last unpin (the fault still lands,
                    # just after the lease contract is honored).
                    self._deferred_evict.add(oid)
                    deferred += 1
                else:
                    self._delete_locked(oid)
        if victims:
            logger.warning("chaos: evicted %d object(s) (%d deferred to "
                           "unpin) from store %s",
                           len(victims) - deferred, deferred, self.address)
        return len(victims)

    def pin(self, object_id: str) -> None:
        """Take a reader lease: while held, the object is not dropped,
        spilled, or chaos-evicted (its zero-copy views stay valid)."""
        with self._lock:
            e = self._objects.get(object_id)
            if e is not None:
                _ownership.store_lease(e, object_id)

    def unpin(self, object_id: str, count: int = 1) -> None:
        """Release reader lease(s); fires any chaos eviction deferred
        while the object was leased. Leases on orphaned blocks (the
        entry was deleted or its id re-created while leased) drain
        first — the caller's leases were taken on that older block."""
        with self._lock:
            orph = self._orphans.get(object_id)
            while count > 0 and orph:
                rec = orph[0]
                take = min(count, rec[1])
                rec[1] -= take
                count -= take
                if rec[1] == 0:
                    self._arena_release_locked(rec[0])
                    orph.pop(0)
            if orph is not None and not orph:
                self._orphans.pop(object_id, None)
            if count <= 0:
                return
            e = self._objects.get(object_id)
            if e is None:
                self._deferred_evict.discard(object_id)
                return
            _ownership.store_unlease(e, object_id, count)
            if e.leases == 0 and object_id in self._deferred_evict:
                self._deferred_evict.discard(object_id)
                self._delete_locked(object_id)

    # -- node-to-node transfer --------------------------------------------

    def read_chunk(self, object_id: str, offset: int, length: int) -> bytes:
        with self._lock:
            e = self._objects.get(object_id)
            if e is None or not e.sealed:
                raise KeyError(f"read_chunk: {object_id} not sealed here")
            e.last_access = time.time()
            length = min(length, e.size - offset)
            if e.offset is not None:
                return bytes(self.arena.view(e.offset + offset, length))
            path = e.path
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def pull(self, object_id: str, from_store: Tuple[str, int],
             size: int, lease: bool = False) -> Tuple:
        """Pull an object from a peer store into this one (chunked).
        lease=True takes a reader lease on the local replica so the
        returned descriptor is safe for zero-copy views until unpin.
        reference parity: pull_manager.h / push_manager.h chunk streaming."""
        chaos_lib.on_store_op("store_pull", [object_id], self)
        with _spans.span("store.pull", bytes=size):
            return self._pull_impl(object_id, from_store, size,
                                           lease)

    def _pull_impl(self, object_id: str,
                           from_store: Tuple[str, int], size: int,
                           lease: bool) -> Tuple:
        while True:
            with self._lock:
                e = self._objects.get(object_id)
                if e is not None and e.sealed:
                    if e.spilled:
                        # a complete local copy exists on disk: restore
                        # it instead of refetching (the peer may have
                        # evicted its copy)
                        self._restore_locked(object_id)
                        e = self._objects[object_id]
                    if lease:
                        _ownership.store_lease(e, object_id)
                    return self._descriptor(e)
                in_flight = self._pulls_in_flight.get(object_id)
                if in_flight is None:
                    self._pulls_in_flight[object_id] = threading.Event()
                    break
            # another thread is streaming this object: wait, then re-check
            in_flight.wait(timeout=300)
        try:
            return self._pull_stream(object_id, from_store, size,
                                     lease=lease)
        finally:
            with self._lock:
                ev = self._pulls_in_flight.pop(object_id, None)
            if ev is not None:
                ev.set()

    def _pull_stream(self, object_id: str, from_store: Tuple[str, int],
                     size: int, lease: bool = False) -> Tuple:
        expected = self.create(object_id, size, pin=False)
        client = self._pool.get(tuple(from_store))
        off = 0
        while off < size:
            chunk = client.call("store_read_chunk", object_id=object_id,
                                offset=off, length=CHUNK_SIZE)
            if not chunk:
                raise IOError(f"short read pulling {object_id}")
            with self._lock:
                e = self._objects.get(object_id)
                if e is None or self._descriptor(e) != expected:
                    # deleted or re-created (different allocation) while
                    # we streamed: writing at the old offsets would land
                    # inside other objects' blocks
                    raise KeyError(f"{object_id} replaced mid-pull")
                if e.offset is not None:
                    self.arena.view(e.offset + off, len(chunk))[:] = chunk
                else:
                    with open(e.path, "r+b") as f:
                        f.seek(off)
                        f.write(chunk)
            off += len(chunk)
        self.seal(object_id)
        with self._lock:
            e = self._objects[object_id]
            if lease:
                _ownership.store_lease(e, object_id)
            return self._descriptor(e)

    def list_objects(self) -> List[Dict[str, Any]]:
        """Object-level metadata for the state API (`ray list objects`
        and the memory plane's residency join, memory_plane.py)."""
        now = time.monotonic()
        with self._lock:
            return [{"object_id": oid, "size": e.size, "sealed": e.sealed,
                     "pinned": e.pinned, "leases": e.leases,
                     "spilled": e.spilled,
                     "age_s": max(0.0, now - e.created_mono)}
                    for oid, e in self._objects.items()]

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"used": self.used, "capacity": self.capacity,
                    "num_objects": len(self._objects),
                    "num_leased": sum(1 for e in self._objects.values()
                                      if e.leases > 0),
                    # eviction-exempt bytes (pins + reader leases): the
                    # watchdog's occupancy probe compares these against
                    # used/capacity — pinned > used means the pin/lease
                    # accounting leaked
                    "pinned_bytes": sum(
                        e.size for e in self._objects.values()
                        if (e.pinned > 0 or e.leases > 0)
                        and not e.spilled),
                    "num_spilled": self.num_spilled,
                    "num_restored": self.num_restored,
                    "native_arena": self.arena is not None}

    def shutdown(self) -> None:
        self.server.stop()
        with self._lock:
            for oid in list(self._objects):
                self._delete_locked(oid)
        if self.arena is not None:
            self.arena.close()
            try:
                os.unlink(self.arena_path)
            except OSError:
                pass
        import shutil as _shutil
        _shutil.rmtree(self.spill_dir, ignore_errors=True)


class StoreClient:
    """Per-process client: RPC for lifecycle, direct shared memory for
    payloads (one arena mapping per store instead of one mmap per object)."""

    def __init__(self, store_address: Tuple[str, int]):
        self.address = tuple(store_address)
        self._rpc = rpc_lib.RpcClient(self.address, timeout=None)
        self._lock = TracedLock("store_client")
        self._arenas: Dict[str, Any] = {}     # arena path -> NativeArena
        # file-layout fallback: object id -> (mmap, view, inode)
        self._maps: Dict[str, Tuple[mmap.mmap, memoryview, int]] = {}
        # fast-path put state: the server's arena path ("" = file-layout
        # server, None = not asked yet) and blocks we allocated directly
        # from the process-shared arena but have not registered yet
        self._fast_arena_path: Optional[str] = None
        self._fast_pending: Dict[str, Tuple[int, int]] = {}

    # -- descriptor resolution ----------------------------------------

    def _arena(self, path: str):
        with self._lock:
            a = self._arenas.get(path)
            if a is None:
                from ray_tpu_torch.native import NativeArena
                a = NativeArena(path)
                self._arenas[path] = a
            return a

    def _view(self, object_id: str, desc: Tuple,
              writable: bool = False) -> memoryview:
        if desc[0] == "arena":
            _, path, offset, size = desc
            view = self._arena(path).view(offset, size)
            # Readers get read-only views: a stored object is immutable,
            # and a writable alias would let one consumer corrupt the
            # arrays every other consumer (zero-copy) reads.
            return view if writable else view.toreadonly()
        _, path, size = desc
        return self._map_file(object_id, path, size, writable)

    def _map_file(self, object_id: str, path: str, size: int,
                  writable: bool = False) -> memoryview:
        with self._lock:
            # The inode detects a deleted-and-recreated object id (e.g.
            # lineage re-execution after eviction): a cached map would
            # point at the dead unlinked inode.
            inode = os.stat(path).st_ino
            cached = self._maps.get(object_id)
            if cached is not None:
                if cached[2] == inode:
                    return cached[1]
                self._release_locked(object_id)
            fd = os.open(path, os.O_RDWR if writable else os.O_RDONLY)
            try:
                mm = mmap.mmap(fd, max(size, 1),
                               prot=(mmap.PROT_READ | mmap.PROT_WRITE)
                               if writable else mmap.PROT_READ)
            finally:
                os.close(fd)
            view = memoryview(mm)[:size]
            self._maps[object_id] = (mm, view, inode)
            return view

    # -- lifecycle ------------------------------------------------------

    def _fast_arena(self):
        """The server's arena, attachable for client-side allocation
        (the allocator's lock is process-shared); None when the server
        runs the file-per-object fallback or the native lib is missing
        locally."""
        if self._fast_arena_path is None:
            try:
                # "" caches an authoritative no-arena answer; a transient
                # RPC failure leaves None so the next put re-probes
                # instead of silently pinning this process to the slow
                # path forever
                self._fast_arena_path = self._rpc.call(
                    "store_arena_info") or ""
            except Exception:  # noqa: BLE001 - transient: retry later
                return None
        if not self._fast_arena_path:
            return None
        try:
            return self._arena(self._fast_arena_path)
        except Exception:  # noqa: BLE001 - no local native toolchain
            self._fast_arena_path = ""
            return None

    def shared_arena(self):
        """Public handle on the node-local process-shared arena (or
        None): the same mapping the put fast path allocates from, reused
        by the shm task channel (_private/shm_channel.py) for same-node
        control messages — its allocator lock is process-shared, so any
        local process may alloc and any other may free."""
        return self._fast_arena()

    def create(self, object_id: str, size: int) -> memoryview:
        """Writable block for a new object. Fast path: allocate straight
        from the process-shared arena — no RPC; seal() then registers
        the block with one one-way message, so a put costs zero round
        trips. Falls back to the server's create RPC when the arena is
        unavailable or full (the server can evict/spill; we can't)."""
        arena = self._fast_arena()
        if arena is not None:
            off = arena.alloc(size)
            if off:
                # chaos parity with the server-side create hook, fired
                # exactly once per create (only after committing to this
                # path — an alloc failure falls through to the RPC
                # create, whose handler fires the hook instead). Evict
                # rules actuate on the server through this client's
                # chaos_evict proxy.
                try:
                    chaos_lib.on_store_op("store_create", [object_id],
                                          self)
                except Exception:
                    try:
                        arena.free(off)
                    except ValueError:
                        pass
                    raise
                with self._lock:
                    self._fast_pending[object_id] = (off, size)
                return arena.view(off, max(size, 1))
        desc = self._rpc.call("store_create", object_id=object_id,
                              size=size)
        return self._view(object_id, desc, writable=True)

    def seal(self, object_id: str) -> None:
        with self._lock:
            fast = self._fast_pending.pop(object_id, None)
        # One-way sends: sealing/registering only flips server metadata
        # + notifies waiters, and same-socket ordering guarantees our
        # own later store RPCs observe it — dropping the reply round
        # trip makes a put RPC-free on the fast path. Durability: a
        # send failure (including a chaos drop_connection, which raises
        # in the client hook before anything is sent) surfaces HERE as
        # an exception, so the put fails loudly; a frame accepted by
        # the kernel is only lost if the store process dies, which
        # loses the whole store and lands in the existing
        # ObjectLostError/lineage path anyway.
        if fast is not None:
            off, size = fast
            self._rpc.send_oneway("store_register", object_id=object_id,
                                  offset=off, size=size)
            return
        self._rpc.send_oneway("store_seal", object_id=object_id)

    def put_raw(self, object_id: str, data: bytes) -> None:
        self.put_segments(object_id, [data])

    def put_segments(self, object_id: str, segments: List[Any]) -> None:
        """Scatter-write pre-serialized parts as one object. Large
        payloads are written straight into the shm mapping (no joined
        intermediate bytes); small ones ride a single put_raw RPC."""
        total = sum(len(s) for s in segments)
        if total > CHUNK_SIZE:
            buf = self.create(object_id, total)
            try:
                off = 0
                for s in segments:
                    buf[off:off + len(s)] = s
                    off += len(s)
                self.seal(object_id)
            except BaseException:
                self.abort_create(object_id)
                raise
        elif len(segments) == 1:
            self._rpc.call("store_put_raw", object_id=object_id,
                           data=bytes(segments[0]))
        else:
            self._rpc.call("store_put_segments", object_id=object_id,
                           segments=[bytes(s) for s in segments])

    def get(self, object_ids: List[str], timeout: Optional[float] = None,
            pin: bool = False) -> Dict[str, memoryview]:
        """Zero-copy views of sealed local objects (ONE store_wait RPC
        for the whole batch). pin=True leases every returned object so
        the views outlive LRU pressure; release with unpin()."""
        descs = self._rpc.call("store_wait", object_ids=object_ids,
                               timeout=timeout, pin=pin)
        return {oid: self._view(oid, desc)
                for oid, desc in descs.items()}

    def contains(self, object_id: str) -> bool:
        return self._rpc.call("store_contains", object_id=object_id)

    def chaos_evict(self, object_glob: Optional[str],
                    op_object_ids: List[str]) -> int:
        """Actuator proxy for chaos rules that fire in THIS process
        (fast-path create): forwards the eviction to the store server,
        which owns the objects."""
        return self._rpc.call("store_chaos_evict",
                              object_glob=object_glob,
                              op_object_ids=list(op_object_ids))

    def abort_create(self, object_id: str) -> None:
        """Undo a create whose write/seal failed, so the backing space
        is reclaimed instead of leaking: fast-path blocks are freed
        straight back to the arena (the server never knew), RPC-created
        entries are deleted server-side."""
        with self._lock:
            fast = self._fast_pending.pop(object_id, None)
        if fast is not None:
            arena = self._fast_arena()
            if arena is not None:
                try:
                    arena.free(fast[0])
                except ValueError:
                    pass
            return
        try:
            self._rpc.call("store_delete", object_ids=[object_id])
        except Exception:  # noqa: BLE001 - server gone; nothing to free
            pass

    def pin(self, object_id: str) -> None:
        self._rpc.call("store_pin", object_id=object_id)

    def unpin(self, object_id: str, count: int = 1) -> None:
        self._rpc.call("store_unpin", object_id=object_id, count=count)

    def pull(self, object_id: str, from_store: Tuple[str, int], size: int,
             pin: bool = False) -> memoryview:
        """Zero-copy view of a replica pulled from a peer store. With
        pin=True the replica is leased (LRU/chaos eviction defer) until
        unpin() — the contract long-lived consumers must use. Unpinned
        callers rely on the arena free-quarantine bounding the reuse
        hazard (fine for transient reads like prefetch or immediate
        copies)."""
        desc = self._rpc.call("store_pull", object_id=object_id,
                              from_store=tuple(from_store), size=size,
                              lease=pin)
        return self._view(object_id, desc)

    def delete(self, object_ids: List[str]) -> None:
        self._release(object_ids)
        self._rpc.call("store_delete", object_ids=object_ids)

    def release_views(self, object_ids: List[str]) -> None:
        """Drop this client's mmap views only — a purely local cleanup
        with no RPC, safe to call under caller locks. The server-side
        delete is a separate (blocking) RPC; callers holding locks
        queue it onto an off-lock drainer instead (core_worker's
        borrow-release loop)."""
        self._release(object_ids)

    def _release_locked(self, oid: str) -> None:
        m = self._maps.pop(oid, None)
        if m is not None:
            try:
                m[1].release()
                m[0].close()
            except (BufferError, ValueError):
                pass  # a live numpy view still references the map

    def _release(self, object_ids: List[str]) -> None:
        with self._lock:
            for oid in object_ids:
                self._release_locked(oid)

    def stats(self) -> Dict[str, float]:
        return self._rpc.call("store_stats")

    def close(self) -> None:
        self._rpc.close()
        with self._lock:
            arenas = list(self._arenas.values())
            self._arenas.clear()
        for a in arenas:
            try:
                a.close()
            except Exception:  # noqa: BLE001 - arena already unmapped
                pass
