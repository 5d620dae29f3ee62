"""TracedLock: lockdep-style runtime lock instrumentation.

The static concurrency rules (lint RT014-RT016) see lock *names* in
source; this module is their runtime twin for the lock *objects* those
names become. Every ``TracedLock`` records, always-on:

  - **acquisition-order edges** in a per-process graph: when a thread
    acquires lock B while holding lock A, the edge A->B is recorded
    (first occurrence under a side lock, later ones a racy counter
    bump). A cycle in this graph means two code paths acquire the same
    locks in opposite orders — the classic deadlock-in-waiting that
    only fires under the right interleaving. The metrics watchdog
    walks each process's edge graph every harvest and raises a
    HEALTH_ALERT on the first observed inversion (lockdep semantics:
    the *order* is the bug, no actual deadlock needs to happen).
  - **hold times**: 1-in-8 sampled at release (bucket counts and sums
    scaled back up at export; the hold COUNT stays exact), exported as
    the ``ray_tpu_lock_held_seconds`` histogram per lock name. The
    hold start is stamped on EVERY acquire, so in-progress hold age —
    what the long-hold watchdog probe reads — is always exact.
  - **waiters**: threads blocked in acquire(), exported as the
    ``ray_tpu_lock_waiters`` gauge and shipped with in-progress hold
    age in the harvest digest so the watchdog can flag
    long-hold-with-waiters (a stalled critical section starving a
    queue of threads).

Design constraints mirror the span plane: the uncontended fast path is
a handful of plain attribute/dict operations — no allocation, no
locking, no metrics calls (export happens pull-based at harvest time).
Bookkeeping counters tolerate lost updates under races; the lock
SEMANTICS are exactly the inner ``threading.Lock``/``RLock``'s.

Ownership is *derived*, not stored: each thread's innermost held
traced lock lives in ``_TOPS[thread_ident]`` and locks chain via
``_prev`` (safe: only the exclusive holder writes its own ``_prev``),
so snapshot() reconstructs holder attribution by walking the chains
and the fast path saves two attribute writes. Exits verify the chain
top before restoring it (a method-form ``b.acquire()`` inside a
``with a:`` block leaves ``b`` above ``a``; the splice fallback keeps
``b``'s ownership intact). ``threading.Condition``
works over a TracedLock (it only needs acquire/release/_is_owned);
a Condition.wait() releases the lock through ``release()``, so hold
time correctly ends at the wait and restarts at wakeup.
"""

from __future__ import annotations

import os
import threading
import weakref
from _thread import get_ident as _get_ident
from time import monotonic as _monotonic
from time import perf_counter as _perf
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["TracedLock", "TracedRLock", "snapshot", "digest",
           "find_cycle", "edges", "reset_edges"]

# thread ident -> innermost held TracedLock (chained via ._prev)
_TOPS: Dict[int, Optional["TracedLock"]] = {}
# (outer lock name, inner lock name) -> occurrence count
_EDGES: Dict[Tuple[str, str], int] = {}
_EDGES_LOCK = threading.Lock()
_REGISTRY: "weakref.WeakSet[TracedLock]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()
_registered_export = False

# ray_tpu_lock_held_seconds boundaries; _slow buckets cover (>1ms) so
# bucket 0 (<=1ms) is holds - sum(_slow)
_BOUNDARIES = [0.001, 0.01, 0.1, 1.0, 10.0]


class TracedLock:
    """Drop-in ``threading.Lock`` with lockdep instrumentation.

    ``name`` keys every export (edges, histogram series, digests);
    instances sharing a name aggregate (e.g. one lock per connection).
    """

    _reentrant = False

    __slots__ = ("name", "_acq", "_rel", "_is_locked", "_t0", "_prev",
                 "_waiters", "_holds", "_hold_total", "_slow",
                 "__weakref__")

    def __init__(self, name: str):
        self.name = name
        inner = self._make_inner()
        self._acq = inner.acquire
        self._rel = inner.release
        self._is_locked = getattr(inner, "locked", None)
        self._t0 = 0.0
        self._prev: Optional["TracedLock"] = None
        self._waiters = 0
        self._holds = 0
        self._hold_total = 0.0   # 1-in-8 sampled sum (x8 at export)
        self._slow = [0, 0, 0, 0, 0]  # 1-in-8 sampled >1ms buckets
        with _REGISTRY_LOCK:
            _REGISTRY.add(self)
        _ensure_export_registered()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    # -- fast paths (the `with` statement) ----------------------------
    # __enter__/__exit__ and acquire/release duplicate the bookkeeping
    # on purpose: the with-path is the hot one and must not pay an
    # extra Python call into acquire().

    def __enter__(self) -> "TracedLock":
        if not self._acq(False):
            self._waiters += 1
            try:
                self._acq()
            finally:
                self._waiters -= 1
        # stamp FIRST: a concurrent harvest that sees locked() must
        # never read the previous hold's start (a stale _t0 would fake
        # an hours-long hold into the long-hold watchdog probe)
        self._t0 = _perf()
        i = _get_ident()
        tops = _TOPS
        top = tops.get(i)
        if top is not None:
            k = (top.name, self.name)
            n = _EDGES.get(k)
            if n is None:
                _record_edge(k)
            else:
                _EDGES[k] = n + 1
        self._prev = top
        tops[i] = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        n = self._holds + 1
        self._holds = n
        if not (n & 7):
            dur = _perf() - self._t0
            self._hold_total += dur
            if dur > 0.001:
                s = self._slow
                if dur < 0.01:
                    s[0] += 1
                elif dur < 0.1:
                    s[1] += 1
                elif dur < 1.0:
                    s[2] += 1
                else:
                    s[3 if dur < 10.0 else 4] += 1
        # `with` blocks release LIFO per thread, so this lock is
        # usually the chain top — but a method-form b.acquire() inside
        # the block (still held at exit) would sit above us, and a
        # blind restore would silently unlink it (breaking its
        # Condition._is_owned and holder attribution). One dict read
        # verifies; the splice fallback handles the rare non-top case.
        i = _get_ident()
        tops = _TOPS
        if tops.get(i) is self:
            tops[i] = self._prev
        else:
            _unlink_slow(self, i)
        self._rel()

    # -- method forms (Condition compatibility, direct callers) -------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not self._acq(False):
            if not blocking:
                return False
            self._waiters += 1
            try:
                if not self._acq(True, timeout):
                    return False
            finally:
                self._waiters -= 1
        self._t0 = _perf()  # before bookkeeping; see __enter__
        i = _get_ident()
        top = _TOPS.get(i)
        if top is not None:
            k = (top.name, self.name)
            n = _EDGES.get(k)
            if n is None:
                _record_edge(k)
            else:
                _EDGES[k] = n + 1
        self._prev = top
        _TOPS[i] = self
        return True

    def release(self) -> None:
        # same bookkeeping as __exit__, but with the safe chain unlink:
        # direct callers (Condition.wait's release_save, hand-written
        # acquire/release pairs) may release out of LIFO order
        n = self._holds + 1
        self._holds = n
        if not (n & 7):
            dur = _perf() - self._t0
            self._hold_total += dur
            if dur > 0.001:
                s = self._slow
                if dur < 0.01:
                    s[0] += 1
                elif dur < 0.1:
                    s[1] += 1
                elif dur < 1.0:
                    s[2] += 1
                else:
                    s[3 if dur < 10.0 else 4] += 1
        _unlink_slow(self, _get_ident())
        self._rel()

    def locked(self) -> bool:
        fn = self._is_locked
        return bool(fn()) if fn is not None else self._held_anywhere()

    # -- introspection ------------------------------------------------

    def _held_anywhere(self) -> bool:
        for top in list(_TOPS.values()):
            node, depth = top, 0
            while node is not None and depth < 64:
                if node is self:
                    return True
                node = node._prev
                depth += 1
        return False

    def _is_owned(self) -> bool:
        """threading.Condition protocol: is THIS thread the holder."""
        node = _TOPS.get(_get_ident())
        depth = 0
        while node is not None and depth < 64:
            if node is self:
                return True
            node = node._prev
            depth += 1
        return False

    def held_seconds(self) -> float:
        """Age of the in-progress hold (0.0 when unheld)."""
        return (_perf() - self._t0) if self.locked() else 0.0

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class TracedRLock(TracedLock):
    """Reentrant variant. Only the outermost acquire/release pair does
    lockdep bookkeeping; inner levels bump a depth counter the owner
    thread exclusively touches."""

    _reentrant = True

    __slots__ = ("_depth",)

    def __init__(self, name: str):
        super().__init__(name)
        self._depth = 0

    @staticmethod
    def _make_inner():
        return threading.RLock()

    def __enter__(self) -> "TracedRLock":
        if self._acq(False):
            # success = fresh acquire OR reentrant (we already own it)
            if self._depth:
                self._depth += 1
                return self
        else:
            self._waiters += 1
            try:
                self._acq()
            finally:
                self._waiters -= 1
        self._t0 = _perf()
        self._depth = 1
        i = _get_ident()
        top = _TOPS.get(i)
        if top is not None and top is not self:
            k = (top.name, self.name)
            n = _EDGES.get(k)
            if n is None:
                _record_edge(k)
            else:
                _EDGES[k] = n + 1
        self._prev = top
        _TOPS[i] = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        d = self._depth - 1
        if d:
            self._depth = d
            self._rel()
            return
        self._depth = 0
        TracedLock.__exit__(self, exc_type, exc, tb)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._acq(False):
            if self._depth:
                self._depth += 1
                return True
        else:
            if not blocking:
                return False
            self._waiters += 1
            try:
                if not self._acq(True, timeout):
                    return False
            finally:
                self._waiters -= 1
        self._t0 = _perf()
        self._depth = 1
        i = _get_ident()
        top = _TOPS.get(i)
        if top is not None and top is not self:
            k = (top.name, self.name)
            n = _EDGES.get(k)
            if n is None:
                _record_edge(k)
            else:
                _EDGES[k] = n + 1
        self._prev = top
        _TOPS[i] = self
        return True

    def release(self) -> None:
        d = self._depth - 1
        if d:
            self._depth = d
            self._rel()
            return
        self._depth = 0
        TracedLock.release(self)

    def locked(self) -> bool:
        # RLock has no locked(); acquire(False) would succeed for the
        # owner, so derive from the holder chains instead.
        return self._held_anywhere()

    # Condition-over-RLock protocol: fully release however deep we are,
    # then restore the depth on wakeup.
    def _release_save(self) -> int:
        d = self._depth
        self._depth = 0
        TracedLock.release(self)
        for _ in range(d - 1):
            self._rel()
        return d

    def _acquire_restore(self, d: int) -> None:
        self.acquire()
        for _ in range(d - 1):
            self._acq()
        self._depth = d


def _record_edge(key: Tuple[str, str]) -> None:
    with _EDGES_LOCK:
        if key not in _EDGES:
            _EDGES[key] = 1


def _unlink_slow(lock: TracedLock, ident: int) -> None:
    """Out-of-LIFO release (e.g. Condition.wait on a non-top lock):
    splice the lock out of this thread's holder chain."""
    node = _TOPS.get(ident)
    if node is lock:
        _TOPS[ident] = lock._prev
        return
    depth = 0
    while node is not None and depth < 64:
        nxt = node._prev
        if nxt is lock:
            node._prev = lock._prev
            return
        node = nxt
        depth += 1


# ---------------------------------------------------------------------
# Snapshot / digest / export
# ---------------------------------------------------------------------


def edges() -> Dict[Tuple[str, str], int]:
    """Copy of this process's acquisition-order edge graph."""
    return dict(_EDGES)


def reset_edges() -> None:
    """Test hook: clear the per-process order graph (a stale edge from
    an earlier test would otherwise read as a fresh inversion)."""
    with _EDGES_LOCK:
        _EDGES.clear()


def find_cycle(edge_pairs) -> Optional[List[str]]:
    """First lock-order cycle in the edge set, as the node path
    [a, b, ..., a]; None when the graph is acyclic. Self-edges are
    reentrant re-acquisitions (TracedRLock), not inversions, and are
    ignored. Deterministic: adjacency is scanned in sorted order."""
    adj: Dict[str, List[str]] = {}
    for a, b in edge_pairs:
        if a != b:
            adj.setdefault(a, []).append(b)
    for k in adj:
        adj[k].sort()
    state: Dict[str, int] = {}  # 1 = on stack, 2 = done

    def dfs(node: str, path: List[str]) -> Optional[List[str]]:
        state[node] = 1
        path.append(node)
        for nxt in adj.get(node, ()):
            s = state.get(nxt)
            if s == 1:
                return path[path.index(nxt):] + [nxt]
            if s is None:
                found = dfs(nxt, path)
                if found:
                    return found
        path.pop()
        state[node] = 2
        return None

    for start in sorted(adj):
        if state.get(start) is None:
            found = dfs(start, [])
            if found:
                return found
    return None


def _owner_map() -> Dict[int, List[str]]:
    """thread ident -> names of traced locks it holds (innermost
    first), reconstructed from the holder chains. Best-effort under
    concurrent mutation: a chain is walked bounded and a torn read
    costs one stale entry, never a crash."""
    out: Dict[int, List[str]] = {}
    for ident, top in list(_TOPS.items()):
        names: List[str] = []
        node, depth = top, 0
        while node is not None and depth < 64:
            names.append(node.name)
            node = node._prev
            depth += 1
        if names:
            out[ident] = names
    return out


def _aggregate() -> Dict[str, Dict[str, Any]]:
    """Per-name aggregation over all live instances."""
    with _REGISTRY_LOCK:
        locks = list(_REGISTRY)
    now = _perf()
    agg: Dict[str, Dict[str, Any]] = {}
    for lk in locks:
        a = agg.setdefault(lk.name, {
            "name": lk.name, "instances": 0, "holds": 0,
            "hold_total_s": 0.0, "slow": [0, 0, 0, 0, 0],
            "waiters": 0, "held_now": 0, "held_s": 0.0,
        })
        a["instances"] += 1
        a["holds"] += lk._holds
        # releases are 1-in-8 sampled; scale sums/buckets back up
        a["hold_total_s"] += 8.0 * lk._hold_total
        for j, v in enumerate(lk._slow):
            a["slow"][j] += 8 * v
        a["waiters"] += lk._waiters
        if lk.locked():
            a["held_now"] += 1
            a["held_s"] = max(a["held_s"], now - lk._t0)
    return agg


def snapshot() -> Dict[str, Any]:
    """This process's full lock-plane state for `ray_tpu locks` /
    /api/locks: per-name aggregates, holder attribution, and the
    acquisition-order edge graph (with its cycle, if one exists)."""
    from ray_tpu_torch._private import spans as spans_lib
    agg = _aggregate()
    owners = _owner_map()
    thread_names = {t.ident: t.name for t in threading.enumerate()}
    held_by: Dict[str, List[Dict[str, Any]]] = {}
    for ident, names in owners.items():
        for nm in names:
            held_by.setdefault(nm, []).append(
                {"thread": ident,
                 "thread_name": thread_names.get(ident)})
    for a in agg.values():
        a["held_by"] = held_by.get(a["name"], [])
    edge_list = sorted((a, b, n) for (a, b), n in _EDGES.items())
    return {
        "proc_uid": spans_lib.PROC_UID,
        "pid": os.getpid(),
        "proc": spans_lib.process_label(),
        "node_id": spans_lib.process_node_id(),
        "ts_mono": _monotonic(),
        "locks": sorted(agg.values(), key=lambda a: a["name"]),
        "edges": [[a, b, n] for a, b, n in edge_list],
        "cycle": find_cycle((a, b) for a, b, _n in edge_list),
    }


DIGEST_KEY = "locks"
_DIGEST_EDGE_CAP = 256


def digest() -> Dict[str, Any]:
    """Compact lock digest riding every metrics harvest (the watchdog's
    inversion + long-hold probes read this; see
    metrics_plane.Watchdog._probe_locks). Long-hold candidates are
    pre-filtered loosely here (>0.5s held) — the watchdog applies the
    configured threshold so runtime tuning needs no worker restart."""
    with _REGISTRY_LOCK:
        locks = list(_REGISTRY)
    now = _perf()
    long_holds: List[Dict[str, Any]] = []
    for lk in locks:
        if lk.locked():
            held = now - lk._t0
            if held > 0.5:
                long_holds.append({"name": lk.name,
                                   "held_s": held,
                                   "waiters": lk._waiters})
    edge_list = sorted(_EDGES)
    return {"edges": [[a, b] for a, b in edge_list[:_DIGEST_EDGE_CAP]],
            "edges_dropped": max(0, len(edge_list) - _DIGEST_EDGE_CAP),
            # cycle computed HERE over the FULL edge set: the capped
            # edge list alone could slice a cycle among later-sorted
            # names out of every harvest and blind the watchdog
            "cycle": find_cycle(edge_list),
            "long_holds": long_holds[:64]}


def _export_metrics() -> None:
    """Harvest-time sampler: fold per-lock counters into the process
    metrics registry. The histogram buckets are WRITTEN, not observed
    — the lock fast path keeps its own counts so it never pays a
    metrics call; this runs only on the pull-based harvest cadence."""
    from ray_tpu_torch.util.metrics import Gauge, Histogram, get_or_create
    agg = _aggregate()
    if not agg:
        return
    hist = get_or_create(
        Histogram, "ray_tpu_lock_held_seconds",
        description="traced-lock hold durations, 1-in-8 sampled at "
                    "release and rescaled x8 (bucket counts and sums "
                    "are estimates; the hold COUNT is exact)",
        boundaries=list(_BOUNDARIES), tag_keys=("lock",))
    gauge = get_or_create(
        Gauge, "ray_tpu_lock_waiters",
        description="threads currently blocked waiting on each traced "
                    "lock", tag_keys=("lock",))
    for name, a in agg.items():
        # scaled slow counts may overshoot the exact total on unlucky
        # sampling; clamp so bucket 0 never goes negative
        slow_sum = min(sum(a["slow"]), a["holds"])
        buckets = [max(0, a["holds"] - slow_sum)] + list(a["slow"])
        key = hist._key({"lock": name})
        with hist._lock:
            hist._buckets[key] = buckets
            hist._sums[key] = a["hold_total_s"]
            hist._counts[key] = a["holds"]
        gauge.set(float(a["waiters"]), tags={"lock": name})


def _ensure_export_registered() -> None:
    """First TracedLock in a process wires the lock plane into the
    metrics harvest: the sampler exports histogram/gauge series and
    the snapshot extra ships the watchdog digest."""
    global _registered_export
    if _registered_export:
        return
    with _REGISTRY_LOCK:
        if _registered_export:
            return
        _registered_export = True
    try:
        from ray_tpu_torch._private import metrics_plane
        metrics_plane.register_sampler("locks", _export_metrics)
        metrics_plane.register_snapshot_extra(DIGEST_KEY, digest)
    except Exception:  # noqa: BLE001 - a metrics-less embedder still
        pass           # gets working locks; telemetry is best-effort
