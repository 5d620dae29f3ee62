"""Ownership protocol: explicit ref/lease/pin state machines.

reference parity: the design argument of Wang et al., "Ownership: A
Distributed Futures System for Fine-Grained Tasks" (NSDI '21) +
reference_count.h / lease protocol state — here made EXPLICIT instead of
implicit across ~15 interacting dicts in core_worker.py. Every count and
state the protocol maintains lives in this module and is mutated ONLY
through methods that funnel into one `transition()` choke point, which

  - validates legal edges (double-release, negative counts and
    free-while-pinned raise `OwnershipError` at the mutation site, not
    as downstream corruption),
  - tolerates the network-raced edges the protocol genuinely has
    (a duplicate remote release, a grant outracing its "queued" reply)
    by recording them as `unmatched:*` anomalies instead of raising,
  - appends every change to a bounded per-process transition ring, so a
    stuck object can explain itself (`ray_tpu ownership`,
    `/api/ownership`, `util.state.ownership`).

The machines:

  RefState (owner side, per object id)     LeaseState (per scheduling key)

      (unknown)                                slots: claim -> park(nm)
         | submit/put                                 -> grant/release
      PENDING ----------- recover <--.         leases: grant -> push(+1 in
         | resolve                   |                 flight) -> settle(-1)
      INLINE|STORE|ERROR ------------'                 -> drop/return
         | free (force for ray.free)           running: lease -> {task hexes}
      FREED   (terminal)

  counts per object: local_refs (ObjectRefs in this process), arg_pins
  (in-flight task args / transit pins / borrower-backed pins), borrower
  registrations per remote address (always a subset of arg_pins by
  construction), replica reader leases on the LOCAL store's pulled copy.

graftlint RT018 enforces the funnel: direct mutation of these count
dicts outside this module is a lint error.

Locking contract: tables do NOT lock. Every mutator must be called with
the owning component's lock held (CoreWorker._lock / StoreServer._lock /
NodeManager._lock); the ring itself is thread-safe.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

# Object location tags (duplicated from core_worker to avoid an import
# cycle; core_worker asserts they match).
INLINE, STORE, ERROR, PENDING, FREED = \
    "inline", "store", "error", "pending", "freed"

_READY = (INLINE, STORE, ERROR)

# Legal location-tag edges for RefState (None = not yet known).
# READY->READY covers duplicate/late completion reports and dynamic-child
# re-registration (idempotent by design); READY->PENDING is lineage
# recovery resetting a lost object for re-execution.
_LOC_EDGES = {
    (None, PENDING), (None, INLINE), (None, STORE), (None, ERROR),
    (PENDING, PENDING), (PENDING, INLINE), (PENDING, STORE),
    (PENDING, ERROR),
    (INLINE, INLINE), (INLINE, STORE), (INLINE, ERROR), (INLINE, PENDING),
    (STORE, STORE), (STORE, INLINE), (STORE, ERROR), (STORE, PENDING),
    (ERROR, ERROR), (ERROR, INLINE), (ERROR, STORE), (ERROR, PENDING),
    (INLINE, FREED), (STORE, FREED), (ERROR, FREED),
    (FREED, FREED),  # idempotent re-free is a no-op, not a bug
}


class OwnershipError(RuntimeError):
    """An illegal ownership-protocol transition (double release,
    negative count, free of a pinned object) caught at its source."""


# ---------------------------------------------------------------------
# Transition ring: the protocol's flight recorder
# ---------------------------------------------------------------------


class TransitionRing:
    """Bounded ring of protocol transitions for this process. Appends
    are cheap (tuple into a deque under a short lock); `snapshot()`
    serves the ownership query plane. Anomalies (unmatched releases,
    clamped counts, rejected edges) are additionally counted by event so
    invariant checkers can assert on totals without scanning."""

    def __init__(self, maxlen: int = 2048):
        self._ring: "collections.deque" = collections.deque(maxlen=maxlen)
        self._seq = itertools.count(1)
        # reentrant: a garbage collection inside record() can run an
        # ObjectRef.__del__ whose release records a transition on this
        # same thread (decr_local -> transition -> record)
        self._lock = threading.RLock()
        self.anomalies: Dict[str, int] = {}

    def record(self, kind: str, key: str, event: str, old: Any,
               new: Any, detail: Optional[str] = None) -> None:
        rec = (next(self._seq), time.time(), kind, key, event, old, new,
               detail)
        with self._lock:
            self._ring.append(rec)
            if event.startswith(("unmatched:", "illegal:")):
                self.anomalies[event] = self.anomalies.get(event, 0) + 1

    def snapshot(self, key_prefix: Optional[str] = None,
                 kind: Optional[str] = None,
                 limit: Optional[int] = None) -> Dict[str, Any]:
        with self._lock:
            recs = list(self._ring)
            anomalies = dict(self.anomalies)
        if kind:
            recs = [r for r in recs if r[2] == kind]
        if key_prefix:
            recs = [r for r in recs if str(r[3]).startswith(key_prefix)]
        if limit:
            recs = recs[-int(limit):]
        return {
            "transitions": [
                {"seq": r[0], "ts": r[1], "kind": r[2], "key": r[3],
                 "event": r[4], "old": r[5], "new": r[6],
                 "detail": r[7]} for r in recs],
            "anomalies": anomalies,
        }


_RING = TransitionRing()


def ring() -> TransitionRing:
    return _RING


def anomaly_counts() -> Dict[str, int]:
    """Per-process `unmatched:*` / `illegal:*` totals (fuzzer oracle)."""
    with _RING._lock:
        return dict(_RING.anomalies)


def transition(kind: str, key: str, event: str, old: Any, new: Any, *,
               strict: bool = True, signed: bool = False,
               detail: Optional[str] = None) -> Any:
    """THE choke point: every protocol state change funnels through
    here. Validates the edge — negative counts and illegal location
    edges either raise (`strict`, the in-process default: the caller
    holds both sides of the books, so a mismatch is a local bug) or are
    recorded as anomalies and clamped (network-raced edges: a duplicate
    remote release is the peer's history, not this process's
    corruption). `signed` counters may legally dip below zero (the
    parked-request buckets, where a grant can outrace its own "queued"
    reply). Returns the value actually committed (clamped when
    non-strict)."""
    illegal = None
    committed = new
    if isinstance(new, int) and new < 0 and not signed:
        illegal = f"count below zero ({old} -> {new})"
        committed = 0
    elif kind == "ref.loc" and (old, new) not in _LOC_EDGES:
        illegal = f"location edge {old} -> {new}"
        committed = old
    if illegal is None:
        _RING.record(kind, key, event, old, new, detail)
        return committed
    _RING.record(kind, key, f"illegal:{event}" if strict
                 else f"unmatched:{event}", old, new,
                 detail or illegal)
    if strict:
        raise OwnershipError(
            f"illegal ownership transition [{kind}] {event} on "
            f"{str(key)[:16]}: {illegal}"
            f"{' (' + detail + ')' if detail else ''}")
    return committed


# ---------------------------------------------------------------------
# RefState: owner-side per-object machine
# ---------------------------------------------------------------------


class RefTable:
    """Owner-side reference table: object location states plus every
    count that holds an object alive from this process. Mutate ONLY via
    methods; callers hold CoreWorker._lock (see module docstring)."""

    def __init__(self):
        # oid hex -> location tuple (tag, ...); the object directory
        self.objects: Dict[str, Tuple] = {}
        self.local_refs: Dict[str, int] = {}
        self.arg_pins: Dict[str, int] = {}
        self.borrowed: Dict[str, Tuple[str, int]] = {}
        self.borrower_pins: Dict[str, Dict[Tuple[str, int], int]] = {}
        self.replica_leases: Dict[str, int] = {}
        # enclosing-result oid hex -> [(owner_addr, nested oid hex)]
        self.nested_borrows: Dict[str, List[Tuple]] = {}
        # (deadline, local hexes, remote (addr, hex) keys) transit pins
        self.ttl_pins: List[Tuple] = []
        # outgoing REMOTE transit pins (pin_refs sent a cw_add_ref we
        # have not yet queued the release for): counts by oid hex. The
        # claim evidence behind cw_claims — without it, an owner's
        # reconciliation sweep could release a transit pin while the
        # done-report it protects is still in flight (the ADVICE-r5
        # freed-nested-object race, reintroduced via anti-entropy)
        self.transit_out: Dict[str, int] = {}

    # ---- location state ----------------------------------------------

    def loc_tag(self, h: str) -> Optional[str]:
        loc = self.objects.get(h)
        return loc[0] if loc is not None else None

    def set_location(self, h: str, loc: Tuple, *, event: str,
                     force: bool = False) -> Optional[Tuple]:
        """Commit a location transition. Freeing while this process
        still counts live claimants raises unless `force` (ray.free's
        explicit contract is "free even though referenced")."""
        old = self.objects.get(h)
        old_tag = old[0] if old is not None else None
        new_tag = loc[0]
        if new_tag == FREED and not force and (
                self.local_refs.get(h, 0) > 0
                or self.arg_pins.get(h, 0) > 0):
            transition("ref.loc", h, f"illegal:{event}", old_tag, new_tag,
                       strict=False,
                       detail=f"free while pinned (local_refs="
                              f"{self.local_refs.get(h, 0)}, arg_pins="
                              f"{self.arg_pins.get(h, 0)})")
            raise OwnershipError(
                f"free of {h[:16]} while pinned: local_refs="
                f"{self.local_refs.get(h, 0)} arg_pins="
                f"{self.arg_pins.get(h, 0)}")
        if old_tag == FREED and new_tag == FREED:
            return old  # idempotent re-free: no-op, not recorded
        if old_tag == new_tag and old == loc:
            return old  # no-change rewrite (duplicate report)
        transition("ref.loc", h, event, old_tag, new_tag)
        self.objects[h] = loc
        return old

    # ---- local refs --------------------------------------------------
    #
    # Local-ref counts are the protocol's highest-rate events (every
    # ObjectRef construction/destruction). Only the BOUNDARY edges are
    # protocol-relevant — first ref (0 -> 1: borrow registration) and
    # last ref (1 -> 0: release/free) — so only those hit the ring;
    # interior increments are always-legal dict ops and skip the choke
    # point entirely, keeping the put/get hot path free of the ring
    # lock. Illegal decrements still always validate (and raise).

    def incr_local(self, h: str) -> int:
        n = self.local_refs.get(h, 0) + 1
        if n == 1:
            transition("ref.local", h, "add_local_ref", 0, 1)
        self.local_refs[h] = n
        return n

    def decr_local(self, h: str, *, strict: bool = True) -> int:
        old = self.local_refs.get(h, 0)
        if old > 1:
            self.local_refs[h] = old - 1
            return old - 1
        n = transition("ref.local", h, "remove_local_ref",
                       old, old - 1, strict=strict)
        if n <= 0:
            self.local_refs.pop(h, None)
        else:
            self.local_refs[h] = n
        return n

    # ---- borrows we hold at remote owners ----------------------------

    def note_borrow(self, h: str, owner_addr: Tuple[str, int]) -> None:
        transition("ref.borrow", h, "borrow", None, 1,
                   detail=f"owner={owner_addr[0]}:{owner_addr[1]}")
        self.borrowed[h] = tuple(owner_addr)

    def drop_borrow(self, h: str, *,
                    event: str = "borrow_release"
                    ) -> Optional[Tuple[str, int]]:
        addr = self.borrowed.pop(h, None)
        if addr is not None:
            transition("ref.borrow", h, event, 1, 0)
        return addr

    # ---- arg pins (and the borrower registrations behind some) -------

    def pin_arg(self, h: str, n: int = 1, *,
                event: str = "pin_arg") -> int:
        new = self.arg_pins.get(h, 0) + n
        transition("ref.pin", h, event, new - n, new)
        self.arg_pins[h] = new
        return new

    def unpin_arg(self, h: str, n: int = 1, *, strict: bool = True,
                  event: str = "unpin_arg") -> int:
        new = transition("ref.pin", h, event, self.arg_pins.get(h, 0),
                         self.arg_pins.get(h, 0) - n, strict=strict)
        if new <= 0:
            self.arg_pins.pop(h, None)
        else:
            self.arg_pins[h] = new
        return new

    def add_borrower(self, h: str, addr: Tuple[str, int]) -> int:
        """Register one borrower pin: the borrower count AND its backing
        arg pin move together, so borrower_pins <= arg_pins holds by
        construction."""
        by = self.borrower_pins.setdefault(h, {})
        addr = tuple(addr)
        by[addr] = by.get(addr, 0) + 1
        return self.pin_arg(h, event="borrow_pin")

    def release_borrower(self, h: str,
                         addr: Tuple[str, int]) -> Optional[int]:
        """Release one borrower pin. Returns the new arg-pin count when
        the borrower actually held one here, None when unmatched — a
        duplicate/late remote release must NOT decrement a pin some
        other claimant legitimately holds (that was the double-free
        class ADVICE r5 found)."""
        by = self.borrower_pins.get(h)
        addr = tuple(addr)
        if by is None or addr not in by:
            transition("ref.pin", h, "unmatched:borrow_unpin",
                       self.arg_pins.get(h, 0),
                       self.arg_pins.get(h, 0), strict=False,
                       detail=f"borrower={addr[0]}:{addr[1]}")
            return None
        left = by[addr] - 1
        if left <= 0:
            by.pop(addr, None)
            if not by:
                self.borrower_pins.pop(h, None)
        else:
            by[addr] = left
        return self.unpin_arg(h, strict=False, event="borrow_unpin")

    def sweep_borrower(self, addr: Tuple[str, int],
                       only: Optional[List[str]] = None, *,
                       event: str = "borrower_swept"
                       ) -> List[Tuple[str, int]]:
        """Drop every pin a borrower holds — all of them (death sweep)
        or just `only` (reconciliation of oids a LIVE borrower
        disclaims); returns [(oid hex, new arg-pin count)] for the
        caller's free decisions."""
        addr = tuple(addr)
        out: List[Tuple[str, int]] = []
        for h in (list(self.borrower_pins) if only is None
                  else [h for h in only if h in self.borrower_pins]):
            by = self.borrower_pins.get(h)
            if by is None:
                continue
            count = by.pop(addr, 0)
            if not by:
                self.borrower_pins.pop(h, None)
            if count <= 0:
                continue
            out.append((h, self.unpin_arg(
                h, count, strict=False, event=event)))
        return out

    # ---- replica reader leases (local store pulls) -------------------

    def add_replica_lease(self, h: str, n: int = 1) -> int:
        new = self.replica_leases.get(h, 0) + n
        transition("ref.lease", h, "replica_lease", new - n, new)
        self.replica_leases[h] = new
        return new

    def pop_replica_leases(self, h: str) -> int:
        n = self.replica_leases.pop(h, 0)
        if n:
            transition("ref.lease", h, "replica_unlease", n, 0)
        return n

    def drain_replica_leases(self) -> Dict[str, int]:
        out = dict(self.replica_leases)
        for h, n in out.items():
            transition("ref.lease", h, "replica_unlease", n, 0,
                       detail="shutdown drain")
        self.replica_leases.clear()
        return out

    # ---- outgoing transit-pin claims ---------------------------------

    def add_transit_out(self, h: str) -> int:
        new = self.transit_out.get(h, 0) + 1
        transition("ref.transit", h, "transit_out", new - 1, new)
        self.transit_out[h] = new
        return new

    def drop_transit_out(self, h: str) -> int:
        new = transition("ref.transit", h, "transit_out_release",
                         self.transit_out.get(h, 0),
                         self.transit_out.get(h, 0) - 1, strict=False)
        if new <= 0:
            self.transit_out.pop(h, None)
        else:
            self.transit_out[h] = new
        return new

    def claims(self, oid_hexes: List[str]) -> Dict[str, bool]:
        """Does this process still claim each object at its owner? The
        union of every structure that backs a borrower pin we hold
        remotely: borrow records, eager nested-borrow registrations,
        and in-flight outgoing transit pins. The owner's reconciliation
        sweep releases pins we disclaim (its lost-release safety net);
        claims must therefore cover every pin whose release WE will
        eventually send, or the sweep frees live objects."""
        nested: Set[str] = set()
        for entries in self.nested_borrows.values():
            for _addr, h in entries:
                nested.add(h)
        return {h: (h in self.borrowed or h in nested
                    or self.transit_out.get(h, 0) > 0)
                for h in oid_hexes}

    # ---- nested borrows + TTL transit pins ---------------------------

    def note_nested(self, outer_hex: str, entries: List[Tuple]) -> None:
        self.nested_borrows.setdefault(outer_hex, []).extend(entries)
        transition("ref.nested", outer_hex, "nested_borrow",
                   None, len(entries))

    def pop_nested(self, outer_hex: str) -> Optional[List[Tuple]]:
        out = self.nested_borrows.pop(outer_hex, None)
        if out:
            transition("ref.nested", outer_hex, "nested_release",
                       len(out), 0)
        return out

    def add_ttl_pins(self, deadline: float, local: List[str],
                     remote_keys: List[Tuple]) -> None:
        self.ttl_pins.append((deadline, local, remote_keys))
        transition("ref.ttl", f"{len(local)}+{len(remote_keys)}",
                   "ttl_pin", None, len(self.ttl_pins))

    def pop_due_ttl(self, now: float) -> List[Tuple]:
        due = [p for p in self.ttl_pins if p[0] <= now]
        if due:
            # in place: CoreWorker aliases this list, rebinding would
            # silently fork the two views
            self.ttl_pins[:] = [p for p in self.ttl_pins if p[0] > now]
            transition("ref.ttl", f"{len(due)} handles", "ttl_expire",
                       len(self.ttl_pins) + len(due), len(self.ttl_pins))
        return due

    # ---- query -------------------------------------------------------

    def describe(self, h: str) -> Dict[str, Any]:
        return {
            "object_id": h,
            "loc": self.loc_tag(h),
            "local_refs": self.local_refs.get(h, 0),
            "arg_pins": self.arg_pins.get(h, 0),
            "borrower_pins": {
                f"{a[0]}:{a[1]}": n
                for a, n in self.borrower_pins.get(h, {}).items()},
            "borrowed_from": (list(self.borrowed[h])
                              if h in self.borrowed else None),
            "replica_leases": self.replica_leases.get(h, 0),
            "nested_borrows": len(self.nested_borrows.get(h, ())),
        }

    def live_objects(self, cap: int = 512) -> List[Dict[str, Any]]:
        """Objects with any live claim (counts > 0) or a non-terminal
        location — the set an operator asks about."""
        keys: Set[str] = (set(self.local_refs) | set(self.arg_pins)
                          | set(self.borrower_pins)
                          | set(self.replica_leases)
                          | set(self.borrowed))
        keys |= {h for h, loc in self.objects.items()
                 if loc[0] == PENDING}
        out = [self.describe(h) for h in itertools.islice(keys, cap)]
        out.sort(key=lambda r: r["object_id"])
        return out


# ---------------------------------------------------------------------
# LeaseState: owner-side per-scheduling-key machine
# ---------------------------------------------------------------------


@dataclass
class LeaseState:
    """Owner-side per-scheduling-key submission state (reference
    direct_task_transport.cc SchedulingKey): tasks of one shape share a
    queue, lease request slots cover the backlog, and leased workers
    are reused back-to-back while the queue has work. Mutated ONLY via
    LeaseTable methods (RT018); the queue itself is plain FIFO plumbing
    and stays directly accessible."""

    key_hex: str
    queue: "collections.deque" = field(default_factory=collections.deque)
    # outstanding lease requests; every slot is either parked at an NM
    # awaiting an async grant or actively driving the request loop
    requests_in_flight: int = 0
    # per-NM parked counts; signed (a grant can outrace its request's
    # "queued" reply, dipping one bucket to -1 until the reply lands)
    # and clamped at read
    parked_at: Dict[Tuple[str, int], int] = field(default_factory=dict)
    # lease_id -> (worker_address, nm_address, node_id_hex)
    leases: Dict[str, Tuple] = field(default_factory=dict)
    # lease_id -> tasks pushed but not yet completed (pipeline depth)
    lease_inflight: Dict[str, int] = field(default_factory=dict)


class LeaseTable:
    """All LeaseState machines of one process + the lease -> running
    task-hex map (worker-death reports fail exactly these under lease
    reuse + pipelining). Callers hold CoreWorker._lock."""

    def __init__(self):
        self.keys: Dict[Any, LeaseState] = {}
        # lease_id -> set of task hexes pushed-but-incomplete
        self.running: Dict[str, Set[str]] = {}
        # recently processed grant ids: grant delivery is at-least-once
        # (the NM re-queues a lease whose reply failed transiently), and
        # a duplicate grant must not release a second request slot or
        # unpark a second bucket — bounded ring + set for O(1) dedup
        self._grant_ring: "collections.deque" = collections.deque(
            maxlen=512)
        self._grant_seen: Set[str] = set()

    def note_grant(self, lease_id: str) -> bool:
        """Record a grant delivery; False when this lease id was already
        processed (the caller hands the duplicate lease straight back)."""
        if lease_id in self._grant_seen:
            transition("lease.held", lease_id, "grant_duplicate",
                       "held", "held")
            return False
        if len(self._grant_ring) == self._grant_ring.maxlen:
            self._grant_seen.discard(self._grant_ring[0])
        self._grant_ring.append(lease_id)
        self._grant_seen.add(lease_id)
        return True

    def state(self, key: Any) -> LeaseState:
        ks = self.keys.get(key)
        if ks is None:
            # scheduling keys are arbitrary hashables (tuples of
            # resource shape / runtime env / strategy); ring records
            # need a short stable label
            import hashlib
            label = hashlib.sha1(repr(key).encode()).hexdigest()[:12]
            ks = self.keys[key] = LeaseState(key_hex=label)
        return ks

    def get(self, key: Any) -> Optional[LeaseState]:
        return self.keys.get(key) if key is not None else None

    # ---- request slots -----------------------------------------------

    def claim_slot(self, ks: LeaseState) -> int:
        ks.requests_in_flight = transition(
            "lease.slot", ks.key_hex, "slot_claim",
            ks.requests_in_flight, ks.requests_in_flight + 1)
        return ks.requests_in_flight

    def release_slot(self, ks: LeaseState, *, event: str = "slot_release",
                     strict: bool = False) -> bool:
        """Release one request slot. Non-strict by default: several
        paths legitimately race to settle the same slot (grant vs.
        drained-queue vs. node death) and the loser must not blow up —
        but every unmatched release is recorded, so a systematic
        double-release shows up in the anomaly counts."""
        if ks.requests_in_flight <= 0:
            transition("lease.slot", ks.key_hex, f"unmatched:{event}",
                       0, 0, strict=False)
            if strict:
                raise OwnershipError(
                    f"lease slot double-release on key {ks.key_hex}")
            return False
        ks.requests_in_flight = transition(
            "lease.slot", ks.key_hex, event,
            ks.requests_in_flight, ks.requests_in_flight - 1)
        return True

    def reset_slots(self, ks: LeaseState, *, event: str) -> int:
        """Node-death recovery: zero the slot count outright (the
        requests died with the NM; over-counting self-heals — surplus
        grants with an empty queue hand their lease straight back)."""
        n, ks.requests_in_flight = ks.requests_in_flight, 0
        if n:
            transition("lease.slot", ks.key_hex, event, n, 0)
        return n

    def release_slots(self, ks: LeaseState, n: int, *,
                      event: str) -> int:
        """Release up to n slots (dead-NM parked sweep), floored at 0."""
        take = min(n, ks.requests_in_flight)
        if take > 0:
            ks.requests_in_flight = transition(
                "lease.slot", ks.key_hex, event,
                ks.requests_in_flight, ks.requests_in_flight - take)
        return take

    # ---- parked accounting -------------------------------------------

    def park(self, ks: LeaseState,
             addr: Optional[Tuple[str, int]]) -> int:
        addr = tuple(addr) if addr else None
        new = ks.parked_at.get(addr, 0) + 1
        # signed by design: may rebalance a grant that outraced the
        # "queued" reply (bucket at -1 -> 0)
        transition("lease.park", ks.key_hex, "park",
                   new - 1, new, signed=True, detail=f"nm={addr}")
        ks.parked_at[addr] = new
        return new

    def unpark(self, ks: LeaseState,
               addr: Optional[Tuple[str, int]]) -> int:
        addr = tuple(addr) if addr else None
        new = ks.parked_at.get(addr, 0) - 1
        transition("lease.park", ks.key_hex, "unpark",
                   new + 1, new, signed=True, detail=f"nm={addr}")
        ks.parked_at[addr] = new
        return new

    def drop_parked(self, ks: LeaseState,
                    addr: Optional[Tuple[str, int]]) -> int:
        """Discard one NM's parked bucket (node death); returns the
        bucket's (possibly negative, clamped) count."""
        addr = tuple(addr) if addr else None
        n = ks.parked_at.pop(addr, 0)
        if n:
            transition("lease.park", ks.key_hex, "drop_parked",
                       n, 0, strict=False, detail=f"nm={addr}")
        return n

    # ---- leases + pipeline depth -------------------------------------

    def add_lease(self, ks: LeaseState, lease_id: str,
                  info: Tuple) -> None:
        transition("lease.held", lease_id, "grant",
                   None, "held", detail=f"key={ks.key_hex}")
        ks.leases[lease_id] = info

    def drop_lease(self, ks: LeaseState, lease_id: str) -> bool:
        had = ks.leases.pop(lease_id, None) is not None
        ks.lease_inflight.pop(lease_id, None)
        if had:
            transition("lease.held", lease_id, "drop", "held", None)
        return had

    def incr_inflight(self, ks: LeaseState, lease_id: str,
                      task_hex: str) -> int:
        new = ks.lease_inflight.get(lease_id, 0) + 1
        transition("lease.inflight", lease_id, "push", new - 1, new,
                   detail=f"task={task_hex[:16]}")
        ks.lease_inflight[lease_id] = new
        self.running.setdefault(lease_id, set()).add(task_hex)
        return new

    def settle_inflight(self, ks: Optional[LeaseState], lease_id: str,
                        task_hex: Optional[str]) -> None:
        """One pushed task finished (or was superseded): drop it from
        the running set and free its pipeline slot. Tolerant of
        duplicate settles (late completion after a failure report) —
        recorded, never negative."""
        on_lease = self.running.get(lease_id)
        if on_lease is not None and task_hex is not None:
            on_lease.discard(task_hex)
            if not on_lease:
                self.running.pop(lease_id, None)
        if ks is None or lease_id not in ks.lease_inflight:
            return
        old = ks.lease_inflight[lease_id]
        if old <= 0:
            # already settled: duplicate completion report (the report
            # path is at-least-once by design) — visible in the ring,
            # not an anomaly
            transition("lease.inflight", lease_id, "settle_noop",
                       old, 0, detail=f"task={(task_hex or '?')[:16]}")
            return
        new = transition("lease.inflight", lease_id, "settle",
                         old, old - 1,
                         detail=f"task={(task_hex or '?')[:16]}")
        ks.lease_inflight[lease_id] = new

    def drop_running_task(self, lease_id: str, task_hex: str) -> None:
        on_lease = self.running.get(lease_id)
        if on_lease is not None:
            on_lease.discard(task_hex)
            if not on_lease:
                self.running.pop(lease_id, None)

    def pop_running(self, lease_id: str) -> Optional[Set[str]]:
        out = self.running.pop(lease_id, None)
        if out:
            transition("lease.held", lease_id, "fail_running",
                       len(out), 0,
                       detail=",".join(sorted(h[:12] for h in out)))
        return out

    # ---- query -------------------------------------------------------

    def summary(self) -> List[Dict[str, Any]]:
        out = []
        for key, ks in self.keys.items():
            out.append({
                "key": ks.key_hex,
                "queued": len(ks.queue),
                "requests_in_flight": ks.requests_in_flight,
                "parked": sum(max(0, n) for n in ks.parked_at.values()),
                "leases": len(ks.leases),
                "inflight": dict(ks.lease_inflight),
            })
        return out


def lease_drain_report(lease_table: LeaseTable) -> List[str]:
    """Post-quiesce leak report over one process's lease machines: with
    no work outstanding, every request slot, pipeline depth and running
    set must be zero — a nonzero survivor is the ADVICE-r5 stall-leak
    class. Caller holds the owning CoreWorker's lock. Used by the
    fuzz harness's drain phase and the test suites' teardown canary."""
    out: List[str] = []
    for ks in lease_table.keys.values():
        if ks.queue:
            out.append(f"key {ks.key_hex}: {len(ks.queue)} task(s) "
                       f"still queued")
        if ks.requests_in_flight:
            out.append(f"key {ks.key_hex}: {ks.requests_in_flight} "
                       f"lease request slot(s) leaked")
        inflight = {lid: n for lid, n in ks.lease_inflight.items() if n}
        if inflight:
            out.append(f"key {ks.key_hex}: pipeline depth not "
                       f"drained: {inflight}")
    if lease_table.running:
        out.append(f"{len(lease_table.running)} lease(s) still marked "
                   f"running: {sorted(lease_table.running)}")
    return out


# ---------------------------------------------------------------------
# Store-side ledger: reader leases on shared-memory entries
# ---------------------------------------------------------------------


def store_lease(entry: Any, oid: str, n: int = 1) -> int:
    """Take n reader leases on a store entry (zero-copy views stay
    valid while held). Caller holds StoreServer._lock."""
    old = entry.leases
    entry.leases = transition("store.lease", oid, "lease", old, old + n)
    return entry.leases


def store_unlease(entry: Any, oid: str, n: int = 1) -> int:
    """Release up to n reader leases; over-release clamps at zero and
    is recorded (a SIGKILLed reader's leases are reaped by store
    teardown, so its peer's late unpin can legitimately overshoot)."""
    old = entry.leases
    entry.leases = transition("store.lease", oid, "unlease",
                              old, old - n, strict=False)
    return entry.leases


# ---------------------------------------------------------------------
# Node-manager lease ledger
# ---------------------------------------------------------------------


class NMLeases:
    """lease id -> worker id hex, mutated only through grant/release so
    every NM-side lease transition hits the ring. Read access mirrors
    the dict surface node_manager uses."""

    def __init__(self):
        self._m: Dict[str, str] = {}

    def grant(self, lease_id: str, worker_hex: str) -> None:
        transition("nm.lease", lease_id, "grant", None, "leased",
                   detail=f"worker={worker_hex[:12]}")
        self._m[lease_id] = worker_hex

    def release(self, lease_id: str, *,
                event: str = "return") -> Optional[str]:
        wid = self._m.pop(lease_id, None)
        if wid is not None:
            transition("nm.lease", lease_id, event, "leased", None,
                       detail=f"worker={wid[:12]}")
        return wid

    def get(self, lease_id: str) -> Optional[str]:
        return self._m.get(lease_id)

    def __contains__(self, lease_id: str) -> bool:
        return lease_id in self._m

    def __len__(self) -> int:
        return len(self._m)

    def items(self):
        return self._m.items()
