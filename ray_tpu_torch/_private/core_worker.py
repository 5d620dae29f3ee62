"""CoreWorker: embedded in every driver and worker process.

reference parity: src/ray/core_worker/core_worker.h:287 — task submission
(SubmitTask core_worker.cc:1887), actor creation/calls (:1958, :2193), object
put/get (:1148, :1360), ownership + reference counting (reference_count.h:61),
retries (task_manager.h:192) and the executor side (ExecuteTask :2598). The
direct task transports (transport/direct_task_transport.cc,
direct_actor_task_submitter.h) map to the lease + direct-push flow here; the
actor receiver's sequencing queue (actor_scheduling_queue.h:40) maps to the
per-caller seq reordering buffer in _ActorExecutor.
"""

from __future__ import annotations

import collections
import inspect
import logging
import os
import pickle
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import chaos as chaos_lib
from ray_tpu_torch._private import log_plane as _log_plane
from ray_tpu_torch._private import memory_plane as _memory_plane
from ray_tpu_torch._private import metrics_plane as _metrics_plane
from ray_tpu_torch._private import ownership as _ownership
from ray_tpu_torch._private import profiler as _profiler
from ray_tpu_torch._private import rpc as rpc_lib
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private import shm_channel as _shm
from ray_tpu_torch._private import spans as _spans
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import (ActorID, JobID, ObjectID, TaskID, WorkerID,
                                  rand_bytes as _rand_bytes)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import ObjectStoreFullError, StoreClient
from ray_tpu_torch._private.state import TaskSpec, TaskType
from ray_tpu_torch._private.task_events import TaskEventBuffer, now as _ev_now
from ray_tpu_torch.util import locks as _locks_util
from ray_tpu_torch.util.locks import TracedLock, TracedRLock

logger = logging.getLogger(__name__)

# Object location tags (owner's object directory entries)
INLINE, STORE, ERROR, PENDING, FREED = "inline", "store", "error", "pending", "freed"
# the ownership protocol module validates location edges against the
# same tags; a drift between the two would corrupt its state machine
assert (INLINE, STORE, ERROR, PENDING, FREED) == (
    _ownership.INLINE, _ownership.STORE, _ownership.ERROR,
    _ownership.PENDING, _ownership.FREED)

# the package root, for callsite capture: the creation site reported by
# `ray_tpu memory --group-by callsite` is the first frame OUTSIDE the
# framework (the user's put()/.remote() line, not our plumbing)
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _capture_callsite() -> Optional[str]:
    import sys as _sys
    try:
        f = _sys._getframe(2)
    except ValueError:
        return None
    while f is not None:
        path = f.f_code.co_filename
        if not path.startswith(_PKG_ROOT):
            return f"{path}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return None

# Sentinel: materialization must be retried after in-flight recovery.
_RETRY = object()

# CoreWorker instance epochs (see CoreWorker.epoch / ObjectRef.__del__)
import itertools as _itertools  # noqa: E402
_CW_EPOCH = _itertools.count(1)

# Lazy transport metrics (util.metrics registers per-process; created on
# first use so importing this module costs nothing).
_TRANSPORT_COUNTER = None

# Owner-side task outcome counters, harvested cluster-wide by the
# metrics plane (the Grafana "Tasks finished/sec" panel's series).
_TASK_COUNTERS: Dict[str, Any] = {}


def _count_task_outcome(outcome: str) -> None:
    c = _TASK_COUNTERS.get(outcome)
    if c is None:
        try:
            from ray_tpu_torch.util.metrics import Counter, get_or_create
            c = get_or_create(
                Counter, f"ray_tpu_tasks_{outcome}_total",
                description=f"tasks {outcome} as seen by their owner")
        except Exception:  # noqa: BLE001 - metrics are best-effort
            return
        _TASK_COUNTERS[outcome] = c
    try:
        c.inc()
    except Exception:  # noqa: BLE001 - metrics are best-effort
        pass


def _transport_bytes(n: int, site: str) -> None:
    """Count payload bytes copied on the transport plane, by site
    (put = scatter-write into shm, pull = cross-node replica stream)."""
    global _TRANSPORT_COUNTER
    c = _TRANSPORT_COUNTER
    if c is None:
        try:
            from ray_tpu_torch.util.metrics import get_or_create, Counter
            c = get_or_create(
                Counter, "ray_tpu_transport_bytes_copied_total",
                description="payload bytes copied by the object "
                            "transport plane, by site",
                tag_keys=("site",))
        except Exception:  # noqa: BLE001 - metrics are best-effort
            return
        _TRANSPORT_COUNTER = c
    try:
        c.inc(n, tags={"site": site})
    except Exception:  # noqa: BLE001 - metrics are best-effort
        pass


@dataclass
class _TaskEntry:
    spec: TaskSpec
    retries_left: int
    return_ids: List[ObjectID]
    # submission order (monotonic per owner): failure batches re-enqueue
    # in THIS order — submission order is topological for data
    # dependencies, while an arbitrary (hex-sorted) order can queue a
    # dependent ahead of its dependency and deadlock a pipelined lease
    submit_seq: int = 0
    lease_node: Optional[Tuple[str, int]] = None
    node_id_hex: Optional[str] = None  # node the lease was granted on
    sched_key: Optional[bytes] = None  # scheduling-key for lease reuse
    # True while this task's hex sits in its key's queue: retry paths
    # must not append a second copy (double execution)
    in_key_queue: bool = False
    done: bool = False
    # streaming generator returns: children reported incrementally,
    # KEYED by return index (reference StreamingObjectRefGenerator,
    # _raylet.pyx:269) — index keying makes retries/recovery re-reports
    # idempotent instead of appending duplicates
    dynamic_arrived: Dict[int, ObjectID] = field(default_factory=dict)
    # LAZY: created by the first ObjectRefGenerator waiter (under the
    # owner's lock), not per entry — a threading.Event costs ~0.5KB and
    # the 250k-task scale envelope holds an entry per queued task. The
    # completion paths set it only when present; the waiter's 1s wait
    # timeout covers the (setter saw None / waiter just created it)
    # race without any extra locking.
    dynamic_event: Optional[threading.Event] = None

    def wake_dynamic(self) -> None:
        ev = self.dynamic_event
        if ev is not None:
            ev.set()


# Owner-side per-scheduling-key submission state lives in the ownership
# protocol module (ownership.LeaseState): tasks of one shape share a
# queue, lease request slots cover the backlog up to a cap, and leased
# workers are reused back-to-back while the queue has work — one push
# RPC per task instead of a lease round trip per task. All slot/parked/
# lease/pipeline counts mutate through LeaseTable methods (RT018).


@dataclass
class _ActorState:
    actor_id: ActorID
    address: Optional[Tuple[str, int]] = None
    last_address: Optional[Tuple[str, int]] = None
    dead: bool = False
    death_cause: str = ""
    seq: int = 0
    incarnation: int = 0
    queue: List[TaskSpec] = field(default_factory=list)
    # task hex -> incarnation it was pushed to (for failing in-flight tasks
    # of a dead incarnation; reference: direct_actor_task_submitter
    # DisconnectActor fails inflight requests)
    pushed: Dict[str, int] = field(default_factory=dict)
    resolving: bool = False
    # node the live incarnation runs on (from get_actor_info): a push to
    # an actor on the caller's own node takes the shm ring, not loopback
    node_id_hex: Optional[str] = None


class CoreWorker:
    def __init__(self, *, mode: str, job_id: JobID,
                 gcs_address: Tuple[str, int],
                 node_manager_address: Tuple[str, int],
                 store_address: Tuple[str, int],
                 node_id_hex: str,
                 worker_id: Optional[WorkerID] = None,
                 host: str = "127.0.0.1"):
        assert mode in ("driver", "worker")
        # instance epoch: ObjectRefs bind their refcount registration to
        # the CoreWorker instance that counted it (object_ref.__del__) —
        # a stale ref from a shut-down cluster must not release against
        # a successor instance's reference table
        self.epoch = next(_CW_EPOCH)
        self.mode = mode
        self.job_id = job_id
        self.worker_id = worker_id or WorkerID.from_random()
        self.node_id_hex = node_id_hex
        self.gcs_address = tuple(gcs_address)
        self.nm_address = tuple(node_manager_address)
        self._gcs = rpc_lib.RpcClient(self.gcs_address, timeout=120)
        self._nm = rpc_lib.RpcClient(self.nm_address, timeout=120)
        self._pool = rpc_lib.ClientPool(timeout=120)
        self.store = StoreClient(store_address)
        # placement group of the currently-executing task/actor, if any
        self.current_placement_group_id = None

        self._lock = TracedRLock("core_worker")
        # Ownership protocol state (_private/ownership.py): the explicit
        # RefState/LeaseState machines behind this worker's reference
        # counting and lease bookkeeping. The aliases below preserve the
        # historical read surface (memory/metrics planes, tests); every
        # MUTATION goes through the tables' methods, which funnel into
        # ownership.transition() — the choke point that validates legal
        # edges and records the transition ring `ray_tpu ownership`
        # serves. Mutations are made under self._lock (tables don't
        # lock; see ownership.py's locking contract).
        self._own = _ownership.RefTable()
        self._ltab = _ownership.LeaseTable()
        # Owner-side object directory: oid hex -> (tag, ...) location
        self.objects: Dict[str, Tuple] = self._own.objects
        self.object_events: Dict[str, threading.Event] = {}
        # oid hex -> [callback]: fired once when the object becomes ready
        # (value or error), without a blocking get (used by handle-style
        # consumers to observe completion cheaply).
        self._done_callbacks: Dict[str, List[Any]] = {}
        # Reference counting (reference reference_count.h): local refs,
        # submitted-task arg pins, and borrower registration — a process
        # holding a ref it doesn't own registers a pin with the owner
        # (cw_add_ref) on first local ref and releases it (cw_remove_ref)
        # when its last local ref drops, so the object outlives the owner's
        # own release while borrowed.
        self.local_refs: Dict[str, int] = self._own.local_refs
        self.arg_pins: Dict[str, int] = self._own.arg_pins
        # oid hex -> owner addr
        self.borrowed: Dict[str, Tuple[str, int]] = self._own.borrowed
        # oid hex -> reader-lease count held on the LOCAL store's pulled
        # replica (zero-copy views stay valid while leased); released
        # when this process's last local ref to the object drops
        self._replica_leases: Dict[str, int] = self._own.replica_leases
        # Owner-side borrower accounting: oid hex -> {borrower addr: count}.
        # A liveness sweep drops pins of borrowers that died without
        # releasing (reference: ReferenceCounter detects borrower failure
        # via the WaitForRefRemoved long-poll connection breaking).
        self.borrower_pins: Dict[str, Dict[Tuple[str, int], int]] = \
            self._own.borrower_pins
        # One long-lived drainer for borrow releases instead of a thread
        # per dropped ref (releases are fire-and-forget, order irrelevant).
        self._borrow_release_queue: "queue.Queue" = queue.Queue()
        # LOCAL store deletes pending on the drainer (guarded by
        # self._lock). Kept OUT of the FIFO queue: a remote release to
        # a dead node can block one queue item for the pool's full
        # connect timeout, and local frees must not strand store bytes
        # behind it — the drainer batch-flushes this list every
        # iteration, so local eviction lags by at most one item.
        self._local_free_pending: List[str] = []
        # (ready_time, item) releases that failed transiently, waiting
        # out their backoff before re-entering the release queue
        self._release_retries: List[Tuple[float, Tuple]] = []
        self._last_borrower_sweep = time.monotonic()
        # enclosing-result oid hex -> [(owner_addr, nested oid hex)]
        # eager borrows on refs embedded in task results (see
        # _register_nested_borrows)
        self._nested_borrows: Dict[str, List[Tuple]] = \
            self._own.nested_borrows
        # (deadline, local hexes, remote (addr, hex)) transit pins on
        # refs embedded in results this EXECUTOR shipped (see
        # pin_refs_with_ttl); expired by the borrow-release loop
        self._ttl_pins: List[Tuple] = self._own.ttl_pins
        self.tasks: Dict[str, _TaskEntry] = {}
        self.actors: Dict[str, _ActorState] = {}
        self._sched_keys: Dict[bytes, _ownership.LeaseState] = \
            self._ltab.keys
        # lease_id -> set of task hexes pushed-but-incomplete on that
        # lease (worker death reports fail exactly these under lease
        # reuse + pipelining)
        self._lease_running: Dict[str, set] = self._ltab.running
        # actor id hex -> submitted-but-unfinished calls from THIS
        # process (max_pending_calls backpressure is per caller, like
        # the reference's submit-queue bound)
        self._actor_pending: Dict[str, int] = {}
        self._store_map_cache = (0.0, {})
        self._put_index = 0
        # memory attribution (memory_plane.py): creation callsites of
        # owned objects (opt-in, Config.memory_callsite_capture) and a
        # short ring of store-resident objects this owner freed — the
        # refcount-vs-residency leak probe's "should be gone" list
        self._callsites: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self._recently_freed: "collections.deque" = \
            collections.deque(maxlen=256)
        self._fn_cache: Dict[str, Any] = {}
        self._subscriptions: Dict[Tuple[str, str], Any] = {}
        self._tls = threading.local()
        self._shutdown = False
        threading.Thread(target=self._borrow_release_loop, daemon=True,
                         name="borrow-release").start()
        # lease-request tickets (key, nslots, nm) drained by the
        # requester thread — see _maybe_request_leases
        self._lease_req_q: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._lease_request_loop, daemon=True,
                         name="lease-request").start()
        # Task state transitions → GCS task sink (reference
        # task_event_buffer.h:206 flushed to GcsTaskManager).
        self.task_events = TaskEventBuffer(rpc_lib.RpcClient(
            self.gcs_address, timeout=30))

        # Driver's root "task" context for put ids
        self._root_task_id = TaskID.of(job_id)

        handlers = {
            "cw_lease_granted": self._on_lease_granted,
            "cw_lease_granted_batch": self._on_lease_granted_batch,
            "cw_lease_respill": self._on_lease_respill,
            "cw_task_done": self._on_task_done,
            "cw_task_done_batch": self._on_task_done_batch,
            "cw_task_failed": self._on_task_failed,
            "cw_dynamic_child": self._on_dynamic_child,
            "cw_get_object": self._on_get_object,
            "cw_wait_object": self._on_wait_object,
            "cw_recover_object": self._on_recover_object,
            "cw_add_ref": self._on_add_ref,
            "cw_remove_ref": self._on_remove_ref,
            # anti-entropy: owners ask whether this process still claims
            # pinned objects (the lost-release safety net; see
            # _sweep_dead_borrowers)
            "cw_claims": self._on_claims,
            "cw_pubsub_push": self._on_pubsub_push,
            "cw_kill_self": self._on_kill_self,
            "cw_can_exit": self._on_can_exit,
            "cw_ping": lambda: "pong",
            # flight-recorder gather point (ray_tpu timeline --spans)
            "cw_spans_snapshot": _spans.snapshot,
            # metrics-plane gather point (dashboard /metrics,
            # `ray_tpu metrics dump`; see _private/metrics_plane.py)
            "cw_metrics_snapshot": _metrics_plane.snapshot_process,
            # debug-plane gather point (`ray_tpu logs`; see
            # _private/log_plane.py) — drivers live outside any node
            # manager's log dir, so the GCS pulls their tails directly
            "cw_logs_snapshot": _log_plane.snapshot,
            # profiling plane (_private/profiler.py): sampler control,
            # one-shot collect (start→sleep→snapshot, singleflight so
            # the concurrent NM+GCS fan-out never double-samples), and
            # device-side xplane traces
            "cw_profile_start":
                lambda hz=100.0: _profiler.sampler().start(hz),
            "cw_profile_stop": lambda: _profiler.sampler().stop(),
            "cw_profile_snapshot":
                lambda reset=False: _profiler.sampler().snapshot(
                    reset=reset),
            "cw_profile_collect":
                lambda duration_s=5.0, hz=100.0, device=False:
                (_profiler.device_profile(duration_s) if device
                 else _profiler.collect_local(duration_s, hz)),
            "cw_device_profile": _profiler.device_profile,
            # memory attribution plane (_private/memory_plane.py):
            # owner-side reference-table dump for `ray_tpu memory`
            "cw_memory_snapshot": self.memory_snapshot,
            # ownership protocol plane (_private/ownership.py): live
            # RefState/LeaseState + transition-ring tail for
            # `ray_tpu ownership` / /api/ownership
            "cw_ownership_snapshot": self.ownership_snapshot,
            # lockdep plane (ray_tpu/util/locks.py): traced-lock
            # snapshot for `ray_tpu locks` / /api/locks
            "cw_locks_snapshot": _locks_util.snapshot,
        }
        self.executor: Optional[_Executor] = None
        if mode == "worker":
            self.executor = _Executor(self)
            handlers["w_push_task"] = self.executor.push_task
            handlers["w_cancel_task"] = self.executor.cancel_task
        # Same-node shm task channel (_private/shm_channel.py): messages
        # from local peers arrive over arena-backed rings and dispatch
        # into this same handler table; shm_doorbell is the only part
        # that rides the socket. Senders are created lazily per peer in
        # _shm_send.
        self._shm_senders: Dict[Tuple[str, int], _shm.Sender] = {}
        self._shm_lock = threading.Lock()
        self._shm_rx: Optional[_shm.Receiver] = None
        # Spec-blob interning (scale envelope, ROADMAP item 1): 250k
        # queued submissions of the same closure/args hold ONE bytes
        # object instead of 250k identical pickles. Keyed by the blob
        # itself — dict hashing + equality beats a crypto digest at
        # these sizes and collisions are impossible by construction.
        self._blob_cache: "collections.OrderedDict[bytes, bytes]" = \
            collections.OrderedDict()
        self._blob_cache_lock = threading.Lock()
        self.blob_cache_hits = 0
        if Config.shm_task_channel:
            # chaos server hook runs here too: a fault rule (delay /
            # kill_worker / stall) must fire identically whether the
            # message rode the ring or the socket
            def _shm_dispatch(method, kw, _handlers=handlers):
                chaos_lib.on_server_dispatch(method)
                return _handlers[method](**kw)
            self._shm_rx = _shm.Receiver(_shm_dispatch)
            handlers["shm_doorbell"] = self._shm_rx.on_doorbell
        self.server = rpc_lib.RpcServer(handlers, host=host)
        self.address = self.server.address
        # one trace row per process in the merged timeline
        _spans.set_process_label(f"{mode}-{self.worker_id.hex()[:8]}",
                                 node_id=node_id_hex)
        # full worker identity for the profiling plane (`ray_tpu
        # profile --worker` matches by id prefix; labels only carry 8
        # hex chars)
        _profiler.set_process_worker(self.worker_id.hex())
        # debug plane: log-line stamps read the current task/actor/trace
        # from this worker's TLS; drivers additionally capture their own
        # `logging` output into the in-process tail ring so `ray_tpu
        # logs` answers for them too (workers already stamp via the
        # worker_main stream redirection)
        _log_plane.set_context_provider(self._log_context)
        if mode == "driver":
            _log_plane.install_capture("driver")
        # lease/executor gauges exported at harvest time (pull-based:
        # the submission hot path never touches the registry); the
        # watchdog's lease_slot_balance probe reads exactly these
        _metrics_plane.register_sampler("core_worker",
                                        self._sample_metric_gauges)
        # compact memory digest on every metrics harvest: the input the
        # watchdog's leak probes compare store residency against, so a
        # leaked pin alerts within two harvest intervals with no extra
        # fan-out (memory_plane.py)
        _metrics_plane.register_snapshot_extra(
            _memory_plane.PROC_DIGEST_KEY, self._memory_digest)
        # Owner-side node-failure detection (reference: the raylet notifies
        # owners via the object directory / lease failures; here the GCS
        # node channel is the death signal). Without it, tasks in flight
        # on a SIGKILLed node would hang their owner forever.
        try:
            self.subscribe("node", self._on_node_event)
            # Actor channel: fail in-flight calls when an actor dies
            # (reference: direct_actor_task_submitter DisconnectActor via
            # the GCS actor pubsub). Without it a caller blocked in get()
            # on a call pushed to a crashed actor hangs forever.
            self.subscribe("actor", self._on_actor_event)
        except Exception:  # noqa: BLE001
            logger.warning("could not subscribe to GCS events",
                           exc_info=True)
        # Chaos plane (_private/chaos.py): identify this process to the
        # fault-injection hooks, pick up the current policy (pubsub only
        # reaches processes alive at publish time), and follow updates.
        from ray_tpu_torch._private import chaos as chaos_lib
        chaos_lib.client().set_context(
            node_id=node_id_hex, is_worker=(mode == "worker"),
            gcs_address=self.gcs_address)
        if mode == "worker":
            # black-box flight dump: a chaos self-kill writes this
            # worker's span-ring tail + recent log records to a sidecar
            # the node manager folds into the crash postmortem
            chaos_lib.client().set_predeath_hook(
                _log_plane.write_flight_dump)
        chaos_lib.fetch_policy(self._gcs.call)
        try:
            self.subscribe("chaos", chaos_lib.on_policy_message)
        except Exception:  # noqa: BLE001 - degrades to fetched policy
            pass

    # ------------------------------------------------------------------
    # Context
    # ------------------------------------------------------------------

    def _sample_metric_gauges(self) -> None:
        """Export point-in-time submission-state gauges for the metrics
        harvest. The lease gauges encode the scheduling invariant the
        watchdog checks: every in-flight request slot must either be
        parked at an NM awaiting a grant or have queued work driving
        it — a slot with neither, held across harvests, is the leak
        ADVICE round 5 found (in_flight - parked > 0 with an empty
        queue)."""
        from ray_tpu_torch.util.metrics import Gauge, get_or_create
        with self._lock:
            in_flight = sum(ks.requests_in_flight
                            for ks in self._sched_keys.values())
            parked = sum(max(0, n)
                         for ks in self._sched_keys.values()
                         for n in ks.parked_at.values())
            queued = sum(len(ks.queue)
                         for ks in self._sched_keys.values())
            leases = sum(len(ks.leases)
                         for ks in self._sched_keys.values())
        get_or_create(
            Gauge, "ray_tpu_lease_requests_in_flight",
            description="outstanding lease requests across scheduling "
                        "keys (owner side)").set(float(in_flight))
        get_or_create(
            Gauge, "ray_tpu_lease_requests_parked",
            description="lease requests parked at a node manager "
                        "awaiting an async grant").set(float(parked))
        get_or_create(
            Gauge, "ray_tpu_lease_queued_tasks",
            description="tasks queued for a lease across scheduling "
                        "keys (owner side)").set(float(queued))
        get_or_create(
            Gauge, "ray_tpu_lease_active_leases",
            description="worker leases currently held by this "
                        "process").set(float(leases))
        ex = self.executor
        get_or_create(
            Gauge, "ray_tpu_executor_queue_depth",
            description="queued + running tasks on this worker's "
                        "executor across all concurrency groups "
                        "(serve replica saturation signal)"
        ).set(float(ex.total_queue_depth() if ex is not None else 0))

    def current_task_id(self) -> TaskID:
        return getattr(self._tls, "task_id", None) or self._root_task_id

    def _log_context(self) -> Tuple[Optional[str], Optional[str],
                                    Optional[str]]:
        """(task, actor, trace) for the debug plane's line stamps —
        read on every stamped write, so: TLS lookups only."""
        tid = getattr(self._tls, "task_id", None)
        aid = self.executor.actor_id if self.executor is not None else None
        return (tid.hex() if tid is not None else None,
                aid.hex() if aid is not None else None,
                getattr(self._tls, "trace_id", None))

    def set_current_task(self, task_id: Optional[TaskID]) -> None:
        self._tls.task_id = task_id
        # mirror into the profiler's cross-thread context registry:
        # threading.local is invisible to the sampler thread, a plain
        # dict write is not (and costs ~100ns per task transition)
        _profiler.set_thread_task(task_id.hex()
                                  if task_id is not None else None)

    # ---- tracing (reference tracing_helper.py context propagation) ---

    def current_trace_id(self) -> Optional[str]:
        return getattr(self._tls, "trace_id", None)

    def current_trace_name(self) -> Optional[str]:
        return getattr(self._tls, "trace_name", None)

    def set_current_trace(self, trace_id: Optional[str],
                          name: Optional[str] = None) -> None:
        self._tls.trace_id = trace_id
        self._tls.trace_name = name
        # mirror into the flight recorder so span records carry the
        # trace, and into the profiler so samples do too
        _spans.set_current_trace(trace_id)
        _profiler.set_thread_trace(trace_id)

    def _attach_trace(self, spec: TaskSpec) -> None:
        """Child tasks inherit the caller's trace; a driver-side submit
        outside any trace starts a fresh one."""
        spec.trace_id = self.current_trace_id() or _rand_bytes(8).hex()
        parent = getattr(self._tls, "task_id", None)
        if parent is not None:
            spec.parent_task_id = parent.hex()
        # the start_trace(name) label rides on this submitter's events
        name = self.current_trace_name()
        if name:
            self.task_events.record(spec.task_id.hex(), trace_name=name)

    def next_put_index(self) -> int:
        with self._lock:
            self._put_index += 1
            return self._put_index

    # ------------------------------------------------------------------
    # Memory attribution (memory_plane.py)
    # ------------------------------------------------------------------

    def _note_callsite(self, oid_hexes: List[str]) -> None:
        """Record the user-code line that created these objects (put /
        .remote()); only called when Config.memory_callsite_capture is
        on — a stack walk per creation is real cost on the put path."""
        site = _capture_callsite()
        if site is None:
            return
        with self._lock:
            for h in oid_hexes:
                self._callsites[h] = site
            while len(self._callsites) > 8192:
                self._callsites.popitem(last=False)

    def memory_snapshot(self, max_objects: Optional[int] = None
                        ) -> Dict[str, Any]:
        """This process's reference table, wire form: everything that
        holds an object alive from here — local refs, submitted-arg
        pins, borrows held (we pinned at a remote owner), borrower pins
        granted (remote processes pinned with us), reader leases on
        pulled replicas, transit pins — plus owned objects' recorded
        location and (opt-in) creation callsite. The GCS joins these
        with store residency into the cluster object table."""
        cap = int(Config.memory_snapshot_max_objects
                  if max_objects is None else max_objects)
        executor = self.executor
        actor_id = executor.actor_id.hex() \
            if executor is not None and executor.actor_id is not None \
            else None
        with self._lock:
            oids = (set(self.objects) | set(self.local_refs)
                    | set(self.arg_pins) | set(self.borrowed)
                    | set(self._replica_leases) | set(self.borrower_pins))
            transit_pins = sum(len(p[1]) + len(p[2])
                               for p in self._ttl_pins)
            records: Dict[str, Dict[str, Any]] = {}
            for h in oids:
                loc = self.objects.get(h)
                tag = loc[0] if loc is not None else None
                if tag == STORE:
                    size: Optional[int] = int(loc[2])
                elif tag in (INLINE, ERROR):
                    size = len(loc[1])
                else:
                    size = None
                records[h] = {
                    "owned": loc is not None and h not in self.borrowed,
                    "loc": tag,
                    "store_addr": (list(loc[1]) if tag == STORE
                                   else None),
                    "size": size,
                    "local_refs": self.local_refs.get(h, 0),
                    "arg_pins": self.arg_pins.get(h, 0),
                    "borrowed_from": (list(self.borrowed[h])
                                      if h in self.borrowed else None),
                    "replica_leases": self._replica_leases.get(h, 0),
                    "borrower_pins": {
                        f"{a[0]}:{a[1]}": n for a, n in
                        self.borrower_pins.get(h, {}).items()},
                    "callsite": self._callsites.get(h),
                }
            dropped = 0
            if len(records) > cap:
                # bounded: keep the held-alive end (store-resident,
                # pinned, borrowed, leased) and count the rest out
                def _weight(item):
                    r = item[1]
                    return ((r["loc"] == STORE) * 4
                            + bool(r["borrower_pins"])
                            + bool(r["replica_leases"])
                            + bool(r["arg_pins"]),
                            r["size"] or 0)
                kept = sorted(records.items(), key=_weight,
                              reverse=True)[:cap]
                dropped = len(records) - cap
                records = dict(kept)
            freed = [oid for oid, _t in self._recently_freed]
        return {
            "proc_uid": _spans.PROC_UID,
            "pid": os.getpid(),
            "label": _spans.process_label(),
            "node_id": self.node_id_hex,
            "worker_id": self.worker_id.hex(),
            "actor_id": actor_id,
            "mode": self.mode,
            "wall_time": time.time(),
            "objects": records,
            "transit_pins": transit_pins,
            "recently_freed": freed,
            "objects_dropped": dropped,
        }

    def _memory_digest(self) -> Dict[str, Any]:
        """Compact form riding every metrics harvest (the leak probes'
        view of who claims what; see memory_plane.py). Computed
        directly from the held-alive sets — NOT via memory_snapshot(),
        whose full record build over the whole object directory
        (including long-dead FREED entries) is too heavy for a 2s
        cadence and would trip the digest cap on long-lived drivers,
        silently disabling the probes."""
        cap = int(Config.memory_digest_max_objects)
        now = time.monotonic()
        with self._lock:
            owned_store = [h for h, loc in self.objects.items()
                           if loc[0] == STORE and h not in self.borrowed]
            leases = dict(self._replica_leases)
            # hold a just-freed object back until its queued remote
            # delete has had time to drain (it rides the borrow-release
            # drainer) — reporting it instantly would race the delete
            # into a false residency-mismatch alert
            freed = [oid for oid, t in self._recently_freed
                     if now - t >= self.FREED_REPORT_GRACE_S]
        return {"kind": self.mode,
                "owned_store": owned_store[:cap],
                "leases": leases,
                "freed": freed,
                "dropped": max(0, len(owned_store) - cap)}

    FREED_REPORT_GRACE_S = 3.0

    # ------------------------------------------------------------------
    # Reference counting
    # ------------------------------------------------------------------

    def add_local_ref(self, ref: ObjectRef) -> None:
        h = ref.hex()
        register_borrow = False
        with self._lock:
            n = self._own.incr_local(h)
            if n == 1 and not self._is_own(ref) and h not in self.borrowed:
                self._own.note_borrow(h, tuple(ref.owner_address))
                register_borrow = True
        if register_borrow:
            # Synchronous so the borrower pin lands before the task that
            # carried this ref completes (its completion releases the
            # sender's in-flight arg pin at the same owner).
            try:
                self._pool.get(tuple(ref.owner_address)).call(
                    "cw_add_ref", oid_hex=h, borrower=self.address)
            except Exception:  # noqa: BLE001 - owner gone; get() will surface
                # Roll back the borrow record: without a registered pin, a
                # later cw_remove_ref would decrement a pin some OTHER
                # borrower legitimately holds.
                with self._lock:
                    self._own.drop_borrow(h, event="borrow_rollback")

    def remove_local_ref(self, ref: ObjectRef) -> None:
        if self._shutdown:
            return
        release_borrow = None
        with self._lock:
            h = ref.hex()
            # strict: a second release of the same ObjectRef is exactly
            # the double-release class the protocol exists to catch
            n = self._own.decr_local(h)
            if n > 0:
                return
            release_borrow = self._own.drop_borrow(h)
            lease_count = self._own.pop_replica_leases(h)
            # owner-side free runs regardless of replica leases: an owned
            # ref whose value was pulled from a remote store still must
            # free on last drop (the lease release below is independent)
            if release_borrow is None and self.arg_pins.get(h, 0) == 0:
                self._maybe_free_locked(h)
        if lease_count:
            # release the local replica's reader lease(s): the arrays a
            # get() handed out die with the last ObjectRef, so the store
            # may evict the block again
            try:
                self.store.unpin(h, count=lease_count)
            except Exception:  # noqa: BLE001 - store gone; lease moot
                pass
        if release_borrow is not None:
            self._borrow_release_queue.put((release_borrow, h))

    def _maybe_free_locked(self, oid_hex: str,
                           force: bool = False) -> None:
        loc = self.objects.get(oid_hex)
        if loc is None or loc[0] in (PENDING, FREED):
            return  # in flight (keep until completion) / already freed
        if loc[0] == STORE:
            # the delete must reach the store that HOLDS the primary:
            # a task result created pinned in the executing worker's
            # node store used to be freed only from the OWNER's local
            # store, leaking the remote primary forever (found by the
            # memory plane's residency-mismatch probe). Queued onto the
            # borrow-release drainer, NOT sent here — a connect to a
            # dead node can block for the pool's full timeout, and this
            # runs under self._lock (loss just means the probe flags
            # the stranded copy).
            primary_addr = tuple(loc[1])
            if primary_addr != self.store.address:
                self._borrow_release_queue.put(
                    ("store_delete", primary_addr, oid_hex))
            try:
                # client-side mmap release only (no RPC): local views
                # die with the ref. The LOCAL store's delete is an RPC
                # round trip too (StoreClient.delete -> store_delete),
                # and under self._lock it stalled every worker
                # operation whenever the store server was slow
                # (RT015); the drainer batch-flushes it off the lock.
                self.store.release_views([oid_hex])
            except Exception:  # noqa: BLE001 - store gone; probe flags leftovers
                pass
            self._local_free_pending.append(oid_hex)
            self._borrow_release_queue.put(("local_free",))
            # residency-mismatch probe input: this object SHOULD now be
            # gone from every store. Timestamped so the digest can hold
            # a just-freed object back while the queued remote delete
            # drains (memory_plane.py)
            self._recently_freed.append((oid_hex, time.monotonic()))
        self._callsites.pop(oid_hex, None)
        # the RefState machine rejects free-while-pinned here unless
        # forced (ray.free's explicit "free even though referenced")
        self._own.set_location(oid_hex, (FREED,), event="free",
                               force=force)
        # wake + retire any parked waiter event (waiters re-check the
        # location and see FREED; events are waiter-created and bounded
        # by live waits, never by object count)
        ev = self.object_events.pop(oid_hex, None)
        if ev is not None:
            ev.set()
        # release eager borrows on refs nested inside this result (see
        # _register_nested_borrows): remote owners via the async release
        # queue; locally-owned nested objects unpin (and may free) here
        nested = self._own.pop_nested(oid_hex)
        if nested:
            for owner_addr, ref_hex in nested:
                if owner_addr == self.address:
                    n = self._own.unpin_arg(ref_hex,
                                            event="nested_unpin")
                    if n <= 0 and self.local_refs.get(ref_hex, 0) == 0:
                        self._maybe_free_locked(ref_hex)
                else:
                    self._borrow_release_queue.put((owner_addr, ref_hex))

    def _register_nested_borrows(self, outer_hex: str,
                                 nested_refs: List[Tuple]) -> None:
        """Eagerly borrow refs embedded in a task result, keyed to the
        enclosing result object: kept exactly as long as the result
        itself, independent of when (or whether) this process
        deserializes it. Deserialization's own add_local_ref stacks a
        second, independently-released count on the same owner pins."""
        recorded = []
        for oid, owner_addr in nested_refs:
            addr = tuple(owner_addr)
            if addr == self.address:
                with self._lock:
                    self._own.pin_arg(oid.hex(), event="nested_pin")
            else:
                # transit claim bridges the gap until note_nested below
                # records the durable claim (the owner's reconciliation
                # sweep must never see a claimless pin)
                with self._lock:
                    self._own.add_transit_out(oid.hex())
                try:
                    self._pool.get(addr).call(
                        "cw_add_ref", oid_hex=oid.hex(),
                        borrower=self.address)
                except Exception:  # noqa: BLE001 — owner gone; the get
                    with self._lock:  # will surface the loss
                        self._own.drop_transit_out(oid.hex())
                    continue
            recorded.append((addr, oid.hex()))
        if recorded:
            with self._lock:
                self._own.note_nested(outer_hex, recorded)
                for addr, h in recorded:
                    if addr != self.address:
                        self._own.drop_transit_out(h)

    def add_done_callback(self, ref: ObjectRef, cb: Any) -> None:
        """Invoke cb() once when the owned object is no longer pending.
        Fires immediately if already resolved. Callbacks must be cheap
        (they run on completion-handling threads)."""
        h = ref.hex()
        with self._lock:
            loc = self.objects.get(h)
            if loc is None or loc[0] != PENDING:
                fire_now = True
            else:
                self._done_callbacks.setdefault(h, []).append(cb)
                fire_now = False
        if fire_now:
            try:
                cb()
            except Exception:  # noqa: BLE001
                logger.exception("done callback failed")

    def _fire_done_callbacks(self, oid_hexes) -> None:
        cbs: List[Any] = []
        with self._lock:
            for h in oid_hexes:
                cbs.extend(self._done_callbacks.pop(h, []))
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001
                logger.exception("done callback failed")

    def _drain_local_frees(self) -> None:
        """Flush pending LOCAL store deletes in one batched ONE-WAY
        send. Runs on the drainer thread (never under self._lock) at
        every loop iteration, so local frees overtake remote releases
        that may be blocked connecting to dead nodes. Deliberately NOT
        StoreClient.delete: that client's channel is shared with the
        put/get hot path, and a slow store_delete handler would hold
        its per-call lock against the next put for the handler's full
        duration — the pool connection (the one the remote-primary
        delete path already uses) keeps the stall off the data path,
        and a one-way send never waits on the handler at all."""
        with self._lock:
            batch, self._local_free_pending = \
                self._local_free_pending, []
        if batch:
            try:
                self._pool.get(self.store.address).send_oneway(
                    "store_delete", object_ids=batch)
            except Exception:  # noqa: BLE001 - store gone; the
                pass           # residency probe flags leftovers

    # Transient-failure budget for protocol releases riding the drainer
    # (borrow releases, remote-primary deletes): a dropped connection
    # must not leak the pin/copy forever — the item re-queues with
    # backoff and only a peer that stays unreachable this long loses it
    # (the dead-borrower sweep / leak probes then own the cleanup).
    RELEASE_RETRY_ATTEMPTS = 4
    RELEASE_RETRY_BACKOFF_S = 0.5

    def _requeue_release(self, item: Tuple, attempts: int) -> None:
        if attempts >= self.RELEASE_RETRY_ATTEMPTS:
            logger.warning("giving up on protocol release %s after %d "
                           "attempts", item[:2], attempts)
            return
        with self._lock:
            self._release_retries.append(
                (time.monotonic()
                 + self.RELEASE_RETRY_BACKOFF_S * (attempts + 1), item))

    def _drain_release_retries(self) -> None:
        now = time.monotonic()
        with self._lock:
            due = [it for t, it in self._release_retries if t <= now]
            self._release_retries = [
                (t, it) for t, it in self._release_retries if t > now]
        for it in due:
            self._borrow_release_queue.put(it)

    def _borrow_release_loop(self) -> None:
        while not self._shutdown:
            try:
                self._expire_ttl_pins()
            except Exception:  # noqa: BLE001
                logger.exception("ttl pin expiry failed")
            try:
                self._drain_local_frees()
                self._drain_release_retries()
            except Exception:  # noqa: BLE001
                logger.exception("local free drain failed")
            try:
                item = self._borrow_release_queue.get(timeout=2.0)
            except queue.Empty:
                # Idle: sweep for borrowers that died without releasing.
                # (Sweep cadence rides the queue timeout; retries above
                # need the shorter tick.)
                now = time.monotonic()
                if now - self._last_borrower_sweep >= 10.0:
                    self._last_borrower_sweep = now
                    try:
                        self._sweep_dead_borrowers()
                    except Exception:  # noqa: BLE001
                        logger.exception("borrower sweep failed")
                    # idle gc: refcounting rides __del__, but ObjectRefs
                    # captured in exception-traceback CYCLES (a failed
                    # task's frames hold its arg refs) wait for the gc —
                    # and an idle worker may not allocate enough to
                    # trigger one for minutes, pinning objects at their
                    # owners the whole time (reference: Ray triggers
                    # worker gc under plasma pressure for the same
                    # reason)
                    try:
                        import gc as _gc
                        _gc.collect()
                    # a finalizer crashing mid-collection must not kill
                    # the drainer; the cycle just waits for the next tick
                    except Exception:  # noqa: BLE001  graftlint: disable=RT013
                        pass
                continue
            if item is None:
                return
            if len(item) == 1:
                continue  # local_free wake: drained at loop top
            if item[0] == "store_delete":
                # remote-primary free queued by _maybe_free_locked (the
                # connect must happen OFF the CoreWorker lock)
                _tag, store_addr, oid_hex = item[:3]
                attempts = item[3] if len(item) > 3 else 0
                try:
                    self._pool.get(store_addr).send_oneway(
                        "store_delete", object_ids=[oid_hex])
                except Exception:  # noqa: BLE001 - transient: retry with
                    # backoff; a node that stays gone loses the copy and
                    # the residency probe flags any stranded one
                    self._requeue_release(
                        ("store_delete", store_addr, oid_hex,
                         attempts + 1), attempts)
                continue
            owner_addr, oid_hex = item[:2]
            attempts = item[2] if len(item) > 2 else 0
            try:
                self._pool.get(owner_addr).call("cw_remove_ref",
                                                oid_hex=oid_hex,
                                                borrower=self.address)
            except Exception:  # noqa: BLE001 - transient: retry with
                # backoff so a dropped connection doesn't leak the pin
                # at a LIVE owner forever (a dead owner has nothing to
                # free)
                self._requeue_release((owner_addr, oid_hex, attempts + 1),
                                      attempts)

    def pin_refs(self, refs: List[Any]) -> Tuple[List[str], List[Tuple]]:
        """Pin objects across a result/report hand-off window: locally
        (arg_pins) for objects we own, one-way borrower-pin at the
        remote owner otherwise. Returns a (local hexes, remote keys)
        handle for release_pins_now / release_pins_after. A remote key
        is recorded ONLY when its cw_add_ref send succeeded — recording
        a failed send would make the later release emit an unmatched
        cw_remove_ref that decrements a pin some OTHER borrower
        legitimately holds, freeing a live object (ADVICE r5)."""
        local: List[str] = []
        remote_keys: List[Tuple] = []
        for ref in refs:
            if self._is_own(ref):
                local.append(ref.hex())
            else:
                remote_keys.append((tuple(ref.owner_address), ref.hex()))
        with self._lock:
            for h in local:
                self._own.pin_arg(h, event="transit_pin")
        remote_sent: List[Tuple] = []
        for addr, h in remote_keys:
            # claim evidence for cw_claims BEFORE the send: the owner's
            # reconciliation sweep must never observe the pin without
            # the claim that protects it
            with self._lock:
                self._own.add_transit_out(h)
            try:
                self._pool.get(addr).send_oneway(
                    "cw_add_ref", oid_hex=h, borrower=self.address)
            except Exception:  # noqa: BLE001 — owner gone; the consumer's
                with self._lock:   # get surfaces the loss
                    self._own.drop_transit_out(h)
                continue
            remote_sent.append((addr, h))
        return (local, remote_sent)

    def release_pins_now(self, handle: Tuple[List[str], List[Tuple]]
                         ) -> None:
        """Release a pin_refs handle immediately (the consumer acked:
        its own eager borrows are registered)."""
        local, remote_keys = handle
        with self._lock:
            self._release_local_pins_locked(local)
            for _addr, h in remote_keys:
                self._own.drop_transit_out(h)
        for addr, h in remote_keys:
            self._borrow_release_queue.put((addr, h))

    def release_pins_after(self, handle: Tuple[List[str], List[Tuple]],
                           ttl_s: float) -> None:
        """Schedule a pin_refs handle for TTL release (the fallback when
        no ack will come). Expiry rides the borrow-release loop (≤10s
        granularity) rather than one timer thread per result."""
        local, remote_keys = handle
        with self._lock:
            self._own.add_ttl_pins(time.monotonic() + ttl_s, local,
                                   remote_keys)

    def pin_refs_with_ttl(self, refs: List[Any],
                          ttl_s: float = 30.0) -> None:
        """pin_refs + TTL-scheduled release in one step (callers without
        an ack path)."""
        self.release_pins_after(self.pin_refs(refs), ttl_s)

    def _release_local_pins_locked(self, hexes: List[str]) -> None:
        for h in hexes:
            n = self._own.unpin_arg(h, event="transit_unpin")
            if n <= 0 and self.local_refs.get(h, 0) == 0:
                self._maybe_free_locked(h)

    def _expire_ttl_pins(self) -> None:
        now = time.monotonic()
        with self._lock:
            due = self._own.pop_due_ttl(now)
            if not due:
                return
            for _, local, remote_keys in due:
                self._release_local_pins_locked(local)
                for _addr, h in remote_keys:
                    self._own.drop_transit_out(h)
        for _, _, remote_keys in due:
            for addr, h in remote_keys:
                self._borrow_release_queue.put((addr, h))

    def _pin_args(self, refs: List[ObjectID]) -> None:
        with self._lock:
            for oid in refs:
                self._own.pin_arg(oid.hex(), event="arg_pin")

    def _unpin_args(self, refs: List[ObjectID]) -> None:
        with self._lock:
            for oid in refs:
                h = oid.hex()
                n = self._own.unpin_arg(h, event="arg_unpin")
                if n <= 0 and self.local_refs.get(h, 0) == 0:
                    self._maybe_free_locked(h)

    # ------------------------------------------------------------------
    # Put / Get / Wait / Free
    # ------------------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.for_put(self.current_task_id(), self.next_put_index())
        h = oid.hex()
        if Config.memory_callsite_capture:
            self._note_callsite([h])
        loc = self.store_value(h, value)
        with self._lock:
            self._own.set_location(h, loc, event="put")
            ev = self.object_events.pop(h, None)
            if ev is not None:
                ev.set()
        return ObjectRef(oid, self.address)

    def store_value(self, oid_hex: str, value: Any) -> Tuple:
        """Serialize + store a value with ONE copy of its buffers: the
        envelope is sized up front and header/meta/arrays scatter-write
        directly into the shm block `store.create` returns (no joined
        intermediate blob). Small envelopes stay inline (zero store
        RPCs); returns the location tuple."""
        _t0 = _spans.begin()
        total = 0
        try:
            meta, buffers = ser.serialize(value)
            raws = ser.raw_buffers(buffers)
            total, offsets = ser.plan_envelope(meta, raws)
            if total <= Config.max_inline_object_size:
                out = bytearray(total)
                ser.write_envelope(out, meta, raws, offsets)
                return (INLINE, bytes(out))
            buf = self.store.create(oid_hex, total)
            try:
                ser.write_envelope(buf, meta, raws, offsets)
                self.store.seal(oid_hex)
            except BaseException:
                # reclaim the block: a fast-path allocation the server
                # never saw would otherwise leak arena space until store
                # teardown
                self.store.abort_create(oid_hex)
                raise
            _transport_bytes(total, "put")
            return (STORE, self.store.address, total)
        finally:
            _spans.end("cw.store_value", _t0, bytes=total)

    def store_blob(self, oid_hex: str, blob: bytes) -> Tuple:
        """Write an already-serialized envelope inline or to the local
        shm store; returns its location tuple. Prefer store_value, which
        skips the intermediate blob entirely."""
        if len(blob) <= Config.max_inline_object_size:
            return (INLINE, blob)
        buf = self.store.create(oid_hex, len(blob))
        try:
            buf[:len(blob)] = blob
            self.store.seal(oid_hex)
        except BaseException:
            self.store.abort_create(oid_hex)
            raise
        _transport_bytes(len(blob), "put")
        return (STORE, self.store.address, len(blob))

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None
            ) -> List[Any]:
        """Batched multi-ref get: resolve every ref's location first
        (per-ref wait-graph edges, removed the moment that ref
        resolves), then materialize the whole batch — all local store
        objects in ONE store_wait RPC, remote replicas via pipelined
        concurrent pulls, inline values with zero RPCs."""
        deadline = None if timeout is None else time.monotonic() + timeout
        blocked_notified = False
        _t0 = _spans.begin()
        try:
            hexes = [ref.hex() for ref in refs]
            locs: List[Optional[Tuple]] = [None] * len(refs)
            for i, ref in enumerate(refs):
                need_wait = not self._ready_nowait(ref)
                if need_wait and self.mode == "worker" and not blocked_notified \
                        and getattr(self._tls, "task_id", None) is not None:
                    blocked_notified = True
                    try:
                        self._nm.call("nm_worker_blocked",
                                      worker_id_hex=self.worker_id.hex())
                    except Exception:  # noqa: BLE001 - blocked hint is advisory only
                        pass
                # may raise DeadlockError instead of blocking forever
                edge = self._register_wait_edge(ref) if need_wait else None
                try:
                    locs[i] = self._await_location(ref, hexes[i], deadline)
                finally:
                    # removed the moment THIS ref resolves: an edge held
                    # until the whole multi-ref get returned could close
                    # a false cycle against a peer we no longer wait on
                    if edge is not None:
                        self._remove_wait_edge(edge)
            return self._materialize_many(refs, hexes, locs, deadline)
        finally:
            # single-ref fast gets are 1:1 with their store_wait RPC
            # (already spanned client-side); record the umbrella span
            # only when it adds information — batching, or a get that
            # actually waited
            if len(refs) > 1 or _spans.perf_counter() - _t0 >= 0.001:
                _spans.end("cw.get", _t0, nrefs=len(refs))
            if blocked_notified:
                try:
                    self._nm.call("nm_worker_unblocked",
                                  worker_id_hex=self.worker_id.hex())
                except Exception:  # noqa: BLE001 - unblock hint is advisory only
                    pass

    def _materialize_many(self, refs: List[ObjectRef], hexes: List[str],
                          locs: List[Optional[Tuple]],
                          deadline: Optional[float]) -> List[Any]:
        """Materialize resolved locations as a batch. Local-store refs
        share one store_wait RPC; distinct remote replicas are pulled
        concurrently (pipelined instead of serial ~300µs round trips);
        anything that misses the fast path (inline, errors, lost objects
        needing lineage recovery) falls back to the per-ref path."""
        prefetched: Dict[str, memoryview] = {}
        local_ids = []
        remote: Dict[str, Tuple] = {}
        for h, loc in zip(hexes, locs):
            if loc is None or loc[0] != STORE or h in remote:
                continue
            store_addr = tuple(loc[1])
            if store_addr == self.store.address:
                local_ids.append(h)
            else:
                remote[h] = (store_addr, int(loc[2]))
        if len(local_ids) > 1:
            try:
                prefetched = self.store.get(
                    list(dict.fromkeys(local_ids)), timeout=5)
            except Exception:  # noqa: BLE001 - per-ref path surfaces it
                prefetched = {}
        if len(remote) > 1:
            # pipeline the pulls: each replica streams on its own thread
            # while the others are in flight (leased for zero-copy use,
            # released when this process's last local ref drops)
            import concurrent.futures as _fut
            with _fut.ThreadPoolExecutor(
                    max_workers=min(8, len(remote))) as pool:
                futs = {
                    h: pool.submit(self._pull_replica, h, addr, size)
                    for h, (addr, size) in remote.items()}
            for h, f in futs.items():
                try:
                    prefetched[h] = f.result()
                except Exception:  # noqa: BLE001 - per-ref path retries
                    pass
        out: List[Any] = []
        for ref, h, loc in zip(refs, hexes, locs):
            buf = prefetched.get(h)
            if buf is not None:
                try:
                    out.append(ser.unpack(buf))
                    continue
                except Exception:  # noqa: BLE001 - torn/evicted: re-get
                    logger.warning("batched unpack of %s failed; "
                                   "refetching", h[:16], exc_info=True)
            out.append(self._get_one(ref, deadline))
        return out

    def _pull_replica(self, oid_hex: str, store_addr: Tuple[str, int],
                      size: int) -> memoryview:
        """Pull + lease a remote object's replica into the local store;
        the lease (released with the last local ref, see
        remove_local_ref) keeps the zero-copy view valid."""
        view = self.store.pull(oid_hex, store_addr, size, pin=True)
        with self._lock:
            self._own.add_replica_lease(oid_hex)
        _transport_bytes(size, "pull")
        return view

    def _remove_wait_edge(self, token: str) -> None:
        # token-keyed and idempotent: the rpc layer retries it through
        # connection blips, so a stale edge can't outlive this get
        try:
            self._gcs.call("wait_graph_remove", token=token)
        except Exception:  # noqa: BLE001 - GCS gone; edge moot
            pass

    # Blocking this long before an edge is registered keeps the GCS off
    # the hot path (gets that resolve quickly — the common trajectory
    # plane — never call it) and closes the remove/add race: a peer that
    # just stopped waiting on us has long since sent its removal by the
    # time our registration lands.
    WAIT_EDGE_GRACE_S = 0.2

    def _register_wait_edge(self, ref: ObjectRef) -> Optional[str]:
        """Actor-context blocking get on another actor's pending result:
        register a waits-for edge with the GCS wait graph BEFORE
        blocking; returns the edge's token to remove once the ref
        resolves, or None when no edge applies. If the edge would
        close a cycle, every actor on it is waiting on the next with
        its executor thread held — raise DeadlockError (with the cycle)
        instead of joining the hang. Best-effort: an unreachable GCS
        only costs detection, not the get itself."""
        ex = self.executor
        if ex is None or ex.actor_id is None:
            return None
        if ex.has_spare_capacity():
            # an idle executor thread can still serve calls from cycle
            # peers (async actors, max_concurrency > 1): not a hard
            # deadlock, so don't contribute an edge
            return None
        waiter = ex.actor_id.hex()
        with self._lock:
            entry = self.tasks.get(ref.task_id().hex())
            target = entry.spec.actor_id if entry is not None else None
        if target is None:
            return None  # not an actor task we submitted; no actor edge
        target_hex = target.hex()
        if target_hex == waiter:
            # re-entrant self-get surfaces as a plain hang/timeout
            return None
        # Grace wait on the local completion event (the target came from
        # our own task table, so we own the ref and its event): fast
        # results never involve the GCS at all.
        with self._lock:
            loc = self.objects.get(ref.hex())
            # events are lazy: create one here (same lock as the
            # completion setters) so the grace wait below has something
            # to wait on even when no getter has parked yet
            ev = self.object_events.setdefault(
                ref.hex(), threading.Event()) \
                if loc is not None and loc[0] == PENDING else None
        if loc is None or loc[0] != PENDING:
            return None  # already resolved
        if ev is not None and ev.wait(timeout=self.WAIT_EDGE_GRACE_S):
            return None  # resolved within the grace window
        token = os.urandom(8).hex()
        try:
            cycle = self._gcs.call("wait_graph_add", waiter_hex=waiter,
                                   target_hex=target_hex, token=token)
        except Exception:  # noqa: BLE001 - detection is advisory
            return None
        if cycle is not None:
            from ray_tpu_torch._private.wait_graph import format_cycle
            names = {e["actor_id"]: e["class_name"] for e in cycle}
            path = format_cycle([e["actor_id"] for e in cycle], names)
            raise exc.DeadlockError(
                f"blocking get() would deadlock: waits-for cycle "
                f"{path} (every actor on the cycle holds its executor "
                f"thread; return the ObjectRef, use an async method, or "
                f"raise max_concurrency)",
                cycle=[e["actor_id"] for e in cycle])
        return token

    def _is_own(self, ref: ObjectRef) -> bool:
        return ref.owner_address in (None, self.address)

    def _ready_nowait(self, ref: ObjectRef) -> bool:
        h = ref.hex()
        with self._lock:
            loc = self.objects.get(h)
        if loc is not None and loc[0] != PENDING:
            return True
        if self._is_own(ref):
            return False
        try:
            loc = self._owner_client(ref).call("cw_get_object", oid_hex=h)
        except Exception:  # noqa: BLE001
            return False
        if loc[0] in (PENDING, "unknown"):
            return False
        with self._lock:
            self.objects.setdefault(h, loc)
        return True

    def _owner_client(self, ref: ObjectRef) -> rpc_lib.RpcClient:
        assert ref.owner_address is not None
        return self._pool.get(ref.owner_address)

    def _recover_object(self, oid_hex: str) -> bool:
        """Lineage reconstruction: re-execute the task that created a lost
        object (reference object_recovery_manager.cc:22 RecoverObject →
        task_manager.cc:255 ResubmitTask). Returns True if recovery is in
        flight (or the object is already being recomputed)."""
        oid = ObjectID(bytes.fromhex(oid_hex))
        if oid.is_put():
            return False  # puts have no lineage; their data is gone
        # Verify actual loss first: a borrower's transient pull failure must
        # not trigger a duplicate re-execution over a live primary copy.
        with self._lock:
            loc = self.objects.get(oid_hex)
        if loc is not None and loc[0] == STORE:
            try:
                if self._pool.get(tuple(loc[1])).call(
                        "store_contains", object_id=oid_hex):
                    return True  # primary alive; caller should retry its pull
            except Exception:  # noqa: BLE001 - store/node really gone
                pass
        with self._lock:
            entry = self.tasks.get(oid.task_id().hex())
            if entry is None or entry.spec.task_type != TaskType.NORMAL_TASK:
                return False  # actor tasks aren't safely replayable
            loc = self.objects.get(oid_hex)
            if loc is not None and loc[0] == PENDING:
                return True  # already recomputing
            if loc is not None and loc[0] in (FREED, ERROR):
                return False
            if not entry.done:
                return True  # original execution still in flight
            entry.done = False
            # reset every object this task produced — declared returns AND
            # dynamic-return children (any oid embedding this task id) —
            # so getters wait for the recomputation instead of re-failing
            # on the stale location
            task_prefix = oid.task_id().hex()
            produced = [rid.hex() for rid in entry.return_ids]
            produced += [h2 for h2 in self.objects
                         if h2.startswith(task_prefix)
                         and h2 not in produced]
            for rh in produced:
                if self.objects.get(rh, (PENDING,))[0] not in (FREED, INLINE,
                                                              ERROR):
                    self._own.set_location(rh, (PENDING,),
                                           event="recover")
                    self.object_events.setdefault(rh, threading.Event()).clear()
        logger.info("recovering object %s by resubmitting task %s",
                    oid_hex[:16], entry.spec.function_name)
        # Re-pin args for the re-execution; if an arg object was itself
        # evicted, the executing worker's get() triggers recursive recovery.
        self._pin_args(entry.spec.arg_object_refs)
        threading.Thread(target=self._enqueue_for_lease,
                         args=(entry.spec.task_id.hex(), entry),
                         daemon=True, name="lineage-recover").start()
        return True

    def _on_recover_object(self, oid_hex: str) -> bool:
        return self._recover_object(oid_hex)

    def _await_location(self, ref: ObjectRef, h: str,
                        deadline: Optional[float]) -> Tuple:
        """Block until the ref has a resolved (non-PENDING) location and
        return it — the waiting half of a get, RPC-free for own refs."""
        # Long-polls park server-side for up to 30s; a dedicated
        # per-get connection keeps them off the shared pooled client,
        # where they would head-of-line-block every other call to that
        # owner from this process (RpcClient serializes on one socket).
        longpoll_client: Optional[rpc_lib.RpcClient] = None
        try:
            while True:
                with self._lock:
                    loc = self.objects.get(h)
                    if loc is not None and loc[0] == PENDING:
                        ev = self.object_events.setdefault(
                            h, threading.Event())
                    else:
                        ev = None
                if loc is not None and loc[0] != PENDING:
                    return loc
                if self._is_own(ref):
                    if loc is None:
                        raise exc.ObjectLostError(
                            f"object {h[:16]} unknown to its owner "
                            "(freed?)")
                    # our own pending task result: wait on event
                    remaining = None if deadline is None \
                        else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        raise exc.GetTimeoutError(
                            f"get timed out waiting for {h[:16]}")
                    ev.wait(timeout=min(remaining, 1.0)
                            if remaining is not None else 1.0)
                    continue
                # borrower: long-poll the owner (reference pubsub
                # long-poll; a 5ms busy-poll collapses at scale)
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise exc.GetTimeoutError(
                        f"get timed out waiting for {h[:16]}")
                try:
                    if longpoll_client is None:
                        longpoll_client = rpc_lib.RpcClient(
                            ref.owner_address, timeout=120)
                    loc = longpoll_client.call(
                        "cw_wait_object", oid_hex=h,
                        timeout=min(remaining or 30.0, 30.0))
                except rpc_lib.ConnectionLost:
                    raise exc.OwnerDiedError(
                        f"owner {ref.owner_address} of {h[:16]} died")
                if loc[0] in (PENDING, "unknown"):
                    if deadline is not None and time.monotonic() > deadline:
                        raise exc.GetTimeoutError(
                            f"get timed out waiting for {h[:16]}")
                    time.sleep(0.05 if loc[0] == "unknown" else 0.0)
                    continue
                with self._lock:
                    self.objects.setdefault(h, loc)
                return loc
        finally:
            if longpoll_client is not None:
                longpoll_client.close()

    def _get_one(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        h = ref.hex()
        recover_attempts = [0]
        while True:
            loc = self._await_location(ref, h, deadline)
            result = self._materialize_with_recovery(
                ref, h, loc, recover_attempts)
            if result is _RETRY:
                continue
            return result

    def _materialize_with_recovery(self, ref, h, loc,
                                   recover_attempts: List[int]) -> Any:
        """Materialize, attempting lineage reconstruction on loss. Returns
        _RETRY when recovery is in flight — the caller's loop re-reads the
        (now PENDING) location and waits for the recomputed value."""
        try:
            return self._materialize(h, loc)
        except exc.ObjectFreedError:
            raise
        except exc.ObjectLostError:
            recover_attempts[0] += 1
            if recover_attempts[0] > 3:
                raise
            if self._is_own(ref):
                if not self._recover_object(h):
                    raise
            else:
                with self._lock:
                    self.objects.pop(h, None)  # drop stale cached loc
                try:
                    ok = self._owner_client(ref).call(
                        "cw_recover_object", oid_hex=h)
                except Exception:  # noqa: BLE001
                    raise exc.OwnerDiedError(
                        f"owner {ref.owner_address} of {h[:16]} "
                        "unreachable during recovery") from None
                if not ok:
                    raise
            time.sleep(0.01)
            return _RETRY

    def _materialize(self, oid_hex: str, loc: Tuple) -> Any:
        tag = loc[0]
        if tag == INLINE:
            return ser.unpack(memoryview(loc[1]))
        if tag == STORE:
            _, store_addr, size = loc
            store_addr = tuple(store_addr)
            try:
                if store_addr == self.store.address:
                    # Own/local objects are sealed before their location is
                    # recorded; a short wait distinguishes a momentary race
                    # from real loss (which lineage recovery then handles).
                    bufs = self.store.get([oid_hex], timeout=5)
                else:
                    # zero-copy view of the pulled replica, leased so
                    # eviction can't rewrite it under the deserialized
                    # arrays (released with our last local ref)
                    bufs = {oid_hex: self._pull_replica(
                        oid_hex, store_addr, size)}
            except ObjectStoreFullError:
                raise
            except Exception as e:  # noqa: BLE001 - peer store refused/died
                raise exc.ObjectLostError(
                    f"object {oid_hex[:16]} unavailable from store "
                    f"{store_addr}: {e}") from None
            if oid_hex not in bufs:
                raise exc.ObjectLostError(f"object {oid_hex[:16]} lost in store")
            return ser.unpack(bufs[oid_hex])
        if tag == ERROR:
            err = pickle.loads(loc[1])
            if isinstance(err, exc.RayTaskError):
                raise err.as_instanceof_cause()
            raise err
        if tag == FREED:
            raise exc.ObjectFreedError(f"object {oid_hex[:16]} was freed")
        raise exc.RaySystemError(f"bad object location {loc!r}")

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        while True:
            still = []
            for r in pending:
                (ready if self._ready_nowait(r) else still).append(r)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        # preserve input order
        ready_set = {r.hex() for r in ready}
        ordered_ready = [r for r in refs if r.hex() in ready_set][:num_returns]
        rest = [r for r in refs if r.hex() not in
                {x.hex() for x in ordered_ready}]
        return ordered_ready, rest

    def free(self, refs: List[ObjectRef]) -> None:
        with self._lock:
            for r in refs:
                if self._is_own(r):
                    # explicit ray.free contract: free even though
                    # references may still exist (forced transition)
                    self._maybe_free_locked(r.hex(), force=True)

    # ------------------------------------------------------------------
    # Function export/import (reference _private/function_manager.py)
    # ------------------------------------------------------------------

    def export_function(self, fn: Any) -> str:
        blob = ser.dumps_function(fn)
        import hashlib
        key = f"fn:{self.job_id.hex()}:{hashlib.sha1(blob).hexdigest()}"
        if key not in self._fn_cache:
            self._gcs.call("kv_put", key=key, value=blob, overwrite=False)
            self._fn_cache[key] = fn
        return key

    def import_function(self, key: str) -> Any:
        fn = self._fn_cache.get(key)
        if fn is None:
            blob = self._gcs.call("kv_get", key=key)
            if blob is None:
                raise exc.RaySystemError(f"function {key} not found in GCS")
            fn = ser.loads_function(blob)
            self._fn_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # Normal task submission
    # ------------------------------------------------------------------

    # interning above this trades little dedup for LRU residency: big
    # arg blobs are rare and unlikely to repeat byte-identically
    _BLOB_INTERN_MAX = 64 * 1024

    def _intern_blob(self, blob: bytes) -> bytes:
        """Return a shared bytes object equal to `blob` (LRU-bounded by
        Config.spec_blob_cache_entries). A fan-out of N .remote() calls
        on the same function/args pickles N identical blobs; interning
        keeps one and lets the N-1 copies die young."""
        if not blob or len(blob) > self._BLOB_INTERN_MAX or \
                Config.spec_blob_cache_entries <= 0:
            return blob
        with self._blob_cache_lock:
            c = self._blob_cache
            got = c.get(blob)
            if got is not None:
                c.move_to_end(blob)
                self.blob_cache_hits += 1
                return got
            c[blob] = blob
            if len(c) > Config.spec_blob_cache_entries:
                c.popitem(last=False)
        return blob

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        # lets a same-node executor report cw_task_done over the shm
        # ring instead of the loopback socket
        spec.owner_node_id = self.node_id_hex
        spec.args = self._intern_blob(spec.args)
        return_ids = [ObjectID.for_task_return(spec.task_id, i + 1)
                      for i in range(spec.num_returns)]
        entry = _TaskEntry(spec=spec, retries_left=spec.max_retries,
                           return_ids=return_ids,
                           sched_key=self._sched_key(spec),
                           submit_seq=self.next_put_index())
        with self._lock:
            for oid in return_ids:
                self._own.set_location(oid.hex(), (PENDING,),
                                       event="submit")
            self.tasks[spec.task_id.hex()] = entry
        # the caller's refs register BEFORE the task can complete: the
        # free-on-resolve check in _on_task_done reads local_refs == 0
        # as "nobody can ever reach this result" — a fast completion
        # racing a later registration would free a live result
        refs_out = [ObjectRef(oid, self.address) for oid in return_ids]
        if Config.memory_callsite_capture and return_ids:
            self._note_callsite([oid.hex() for oid in return_ids])
        self._attach_trace(spec)
        self.task_events.record(
            spec.task_id.hex(), state="SUBMITTED", ts_submitted=_ev_now(),
            name=spec.function_name, type="NORMAL_TASK",
            job_id=spec.job_id.hex(), trace_id=spec.trace_id,
            parent_task_id=spec.parent_task_id)
        spec.locality_hints, spec.arg_locations = \
            self._locality_info(spec.arg_object_refs)
        self._pin_args(spec.arg_object_refs)
        self._enqueue_for_lease(spec.task_id.hex(), entry)
        return refs_out

    @staticmethod
    def _sched_key(spec: TaskSpec):
        """Scheduling-key for owner-side lease reuse (reference
        direct_task_transport SchedulingKey): tasks may share a leased
        worker iff everything the lease depends on matches — resource
        shape, runtime env, scheduling strategy/PG slot, and the
        function (keeps max_calls accounting per-function simple)."""
        return spec.scheduling_key()

    def _enqueue_for_lease(self, task_hex: str, entry: _TaskEntry,
                           nm=None) -> None:
        """Queue a task under its scheduling key; at most one lease
        request per key is in flight (the grant/done paths keep draining
        the queue over leased workers and re-request while backlogged)."""
        key = entry.sched_key
        with self._lock:
            ks = self._ltab.state(key)
            if not entry.in_key_queue:
                # retry of a task still queued (e.g. node-death fail of
                # a queued lease head) must not enqueue a second copy —
                # the duplicate would execute concurrently
                ks.queue.append(task_hex)
                entry.in_key_queue = True
        self._maybe_request_leases(key, nm=nm)

    # Cap on outstanding lease requests per scheduling key (reference
    # direct_task_transport max_pending_lease_requests): enough to fan a
    # burst out over several workers, bounded so one key can't flood the
    # NM queue.
    MAX_PENDING_LEASE_REQUESTS = 4

    def _maybe_request_leases(self, key, nm=None) -> None:
        """Issue lease requests until outstanding requests cover the
        backlog (one per queued task, capped): parallelism comes from
        multiple leases, latency from per-lease pipelining.

        With task_lease_batching the NM round trip moves OFF this
        thread entirely: slots are claimed here (so the covered-by-
        backlog invariant holds at claim time), then the requester
        thread ships them — coalescing claims that pile up while one
        RPC is in flight into a single nm_lease_request_batch. The
        submit path's cost drops to local bookkeeping; this is the
        difference between ~1/RTT tasks/s and wire-speed submission."""
        while True:
            with self._lock:
                ks = self._ltab.get(key)
                if ks is None:
                    return
                desired = min(len(ks.queue),
                              self.MAX_PENDING_LEASE_REQUESTS)
                if ks.requests_in_flight >= desired:
                    return
                nslots = desired - ks.requests_in_flight \
                    if Config.task_lease_batching else 1
                for _ in range(nslots):
                    self._ltab.claim_slot(ks)
            if Config.task_lease_batching:
                self._lease_req_q.put((key, nslots, nm))
                return
            self._request_lease_for_key(key, nm=nm)
            nm = None

    def _lease_request_loop(self) -> None:
        """Requester thread: drains claimed-slot tickets, merges them
        per key, and issues the (batch) lease RPCs. Claims were made by
        the enqueuer, so nothing here races the slot accounting; one
        slow NM can only stall its own key's inline send (other keys of
        the same drain round go to short-lived threads)."""
        while not self._shutdown:
            try:
                item = self._lease_req_q.get(timeout=1.0)
            except queue.Empty:
                continue
            if item is None:
                return
            batch = [item]
            try:
                while True:
                    more = self._lease_req_q.get_nowait()
                    if more is not None:
                        batch.append(more)
            except queue.Empty:
                pass
            merged: Dict[bytes, List] = {}
            for key, nslots, nm in batch:
                cur = merged.get(key)
                if cur is None:
                    merged[key] = [nslots, nm]
                else:
                    cur[0] += nslots
                    if nm is not None:
                        cur[1] = nm
            spread = len(merged) > 1
            for key, (nslots, nm) in merged.items():
                if spread:
                    threading.Thread(
                        target=self._send_lease_requests,
                        args=(key, nslots, nm), daemon=True,
                        name="lease-request-key").start()
                else:
                    self._send_lease_requests(key, nslots, nm)

    def _send_lease_requests(self, key, nslots: int, nm=None) -> None:
        try:
            if nslots == 1:
                self._request_lease_for_key(key, nm=nm)
            else:
                self._request_lease_batch_for_key(key, nslots, nm=nm)
        except Exception:  # noqa: BLE001 - a stray error here must not
            # kill the requester thread; the slot-balance watchdog
            # surfaces any slots this leaks
            logger.exception("lease request for key %r failed", key)

    def _release_request_slot(self, key) -> None:
        with self._lock:
            ks = self._ltab.get(key)
            if ks is not None:
                self._ltab.release_slot(ks, event="slot_release")

    def _locality_info(self, arg_ids: List[ObjectID]):
        """(node id hex -> resident arg bytes, oid -> (store, size)) from
        the owner's location cache (reference lease_policy.h:56 +
        the per-arg locations the raylet's dependency manager pulls);
        inline args contribute nothing (they travel in the spec)."""
        if not arg_ids:
            return {}, {}
        store_to_node = self._store_to_node_map()
        hints: Dict[str, float] = {}
        locations: Dict[str, Any] = {}
        with self._lock:
            for oid in arg_ids:
                loc = self.objects.get(oid.hex())
                if loc is not None and loc[0] == STORE:
                    locations[oid.hex()] = (tuple(loc[1]), int(loc[2]))
                    node = store_to_node.get(tuple(loc[1]))
                    if node is not None:
                        hints[node] = hints.get(node, 0.0) + float(loc[2])
        return hints, locations

    def _store_to_node_map(self) -> Dict[Tuple[str, int], str]:
        ts, cached = self._store_map_cache
        if time.monotonic() - ts < 5.0:
            return cached
        try:
            nodes = self._gcs.call("get_all_nodes")
        except Exception:  # noqa: BLE001
            return cached
        mapping = {tuple(n.store_address): n.node_id.hex()
                   for n in nodes if n.alive}
        self._store_map_cache = (time.monotonic(), mapping)
        return mapping

    def _on_lease_respill(self, task_id: TaskID,
                          nm_address: Tuple[str, int],
                          from_address: Optional[Tuple[str, int]] = None
                          ) -> None:
        """Our local raylet re-routed a queued lease to another node that
        became feasible (e.g. a PG bundle committed there)."""
        with self._lock:
            entry = self.tasks.get(task_id.hex())
            if entry is not None:
                ks = self._ltab.get(entry.sched_key)
                if ks is not None:
                    # the queued request is gone at the sending NM: the
                    # slot we hold is no longer parked anywhere until
                    # the re-request below parks it again. The SENDER
                    # names itself — entry.lease_node is unreliable
                    # here, since a grant from another request may have
                    # already pushed this task elsewhere and overwritten
                    # it (older NMs omit from_address; fall back).
                    old = (tuple(from_address) if from_address
                           else tuple(entry.lease_node)
                           if entry.lease_node else None)
                    self._ltab.unpark(ks, old)
        if entry is None:
            return
        # The old queued request is gone at the NM: re-enter the request
        # path at the redirect target (request_in_flight stays held by
        # us). Even when the task is already done (cancelled/retried
        # while its request sat queued) we must NOT return early:
        # _key_head drains dead queue heads and releases the held slot —
        # an early return here leaked requests_in_flight permanently and
        # stalled the key once MAX_PENDING_LEASE_REQUESTS slots were
        # gone (ADVICE round 5; the metrics watchdog's
        # lease_slot_balance probe now alarms on exactly this).
        threading.Thread(
            target=self._request_lease_for_key,
            args=(entry.sched_key,),
            kwargs={"nm": self._pool.get(tuple(nm_address))},
            daemon=True, name="lease-respill").start()

    def _key_head(self, key: bytes):
        """(task_hex, entry) of the first live queued task of the key,
        without popping; releases the caller's request slot and returns
        None when the queue has no live work."""
        with self._lock:
            ks = self._ltab.get(key)
            if ks is None:
                return None
            while ks.queue:
                h = ks.queue[0]
                entry = self.tasks.get(h)
                if entry is not None and not entry.done:
                    return h, entry
                ks.queue.popleft()
                if entry is not None:
                    entry.in_key_queue = False
            self._ltab.release_slot(ks, event="slot_release_drained")
            return None

    def _key_heads(self, key: bytes, n: int):
        """Up to `n` distinct live queued (task_hex, entry) pairs of the
        key, front-drained like _key_head but WITHOUT popping the live
        ones (grants pop via _push_on_lease). The caller holds `n`
        request slots; surplus slots beyond the live work found are
        released here so slot accounting stays covered-by-backlog."""
        heads = []
        with self._lock:
            ks = self._ltab.get(key)
            if ks is None:
                return heads
            while ks.queue:
                h = ks.queue[0]
                entry = self.tasks.get(h)
                if entry is not None and not entry.done:
                    break
                ks.queue.popleft()
                if entry is not None:
                    entry.in_key_queue = False
            for h in ks.queue:
                entry = self.tasks.get(h)
                if entry is None or entry.done:
                    continue
                heads.append((h, entry))
                if len(heads) >= n:
                    break
            for _ in range(n - len(heads)):
                self._ltab.release_slot(
                    ks, event="slot_release_drained" if not heads
                    else "slot_release")
        return heads

    def _request_lease_batch_for_key(self, key: bytes, nslots: int,
                                     nm=None) -> None:
        """Multi-slot lease request: one nm_lease_request_batch RPC
        covers up to `nslots` queue heads (the caller claimed that many
        slots). Replies that queued park their slot at the NM exactly
        like the singleton path; spilled/infeasible replies — and any
        batch-level connection failure — fall back to the singleton
        path, which owns the full spill-following/backoff machinery,
        one claimed slot per remaining reply."""
        heads = self._key_heads(key, nslots)
        if not heads:
            return
        nm_cur = nm if nm is not None else self._nm
        with self._lock:
            for _h, entry in heads:
                # recorded BEFORE the request so an async grant arriving
                # first knows where to return the lease (same contract
                # as the singleton path)
                entry.lease_node = nm_cur.address
        try:
            replies = nm_cur.call(
                "nm_lease_request_batch",
                specs=[entry.spec for _h, entry in heads],
                reply_to=self.address)
        except Exception:  # noqa: BLE001 - connection-level failure:
            # not a task failure. Re-enter the singleton path per held
            # slot; it restarts from the local NM with its own
            # conn-failure budget.
            for _ in heads:
                self._request_lease_for_key(key)
            return
        fallbacks = 0
        spill_nm = None
        with self._lock:
            ks = self._ltab.get(key)
            for kind, payload in replies:
                if kind == "queued" and ks is not None:
                    self._ltab.park(ks, tuple(nm_cur.address))
                else:
                    # "spill"/"infeasible": this slot never parked; the
                    # singleton path below re-drives it (and follows the
                    # first spill target directly)
                    fallbacks += 1
                    if kind == "spill" and spill_nm is None:
                        spill_nm = tuple(payload)
        for i in range(fallbacks):
            self._request_lease_for_key(
                key, nm=self._pool.get(spill_nm)
                if i == 0 and spill_nm is not None else None)

    def _request_lease_for_key(self, key: bytes, nm=None) -> None:
        """Lease a worker for the key's queue head; follow spillback
        redirects (reference direct_task_transport.cc:349,505). Called
        with ONE request slot already claimed by the caller; every exit
        either leaves the request queued at an NM (the grant releases
        the slot) or releases it here. Iterates (not recurses) over
        queue heads so a long run of infeasible tasks fails them one by
        one without growing the stack."""
        while True:
            head = self._key_head(key)
            if head is None:
                return
            task_hex, entry = head
            spec = entry.spec
            attempt = 0
            conn_failures = 0
            nm_cur = nm if nm is not None else self._nm
            nm = None  # a respill redirect only applies to the first head
            verdict = None
            while attempt < 16:
                with self._lock:
                    # Recorded BEFORE the request so the async grant
                    # callback (which may arrive first) can find where to
                    # return it.
                    entry.lease_node = nm_cur.address
                try:
                    kind, payload = nm_cur.call(
                        "nm_request_lease", spec=spec,
                        reply_to=self.address, spill_count=attempt)
                except Exception as e:  # noqa: BLE001
                    # Connection-level failures are NOT task failures:
                    # a spill target died (stale cluster view) or the
                    # local NM hiccuped. Back off and restart from the
                    # local NM — its view drops the dead node once the
                    # GCS health check fires — without burning the
                    # task's retry budget (reference lease clients
                    # retry RPC errors; max_retries is for execution
                    # failures).
                    conn_failures += 1
                    if conn_failures <= 50:
                        time.sleep(0.2)
                        nm_cur = self._nm
                        attempt = 0
                        continue
                    self._release_request_slot(key)
                    self._fail_task(task_hex, "SCHEDULING_FAILED",
                                    f"lease request failed: {e}",
                                    retry=True)
                    return
                if kind == "queued":
                    # grant arrives async; request stays in flight,
                    # now parked at this NM (the grant or a respill
                    # unparks it)
                    with self._lock:
                        ks = self._ltab.get(key)
                        if ks is not None:
                            self._ltab.park(ks, tuple(nm_cur.address))
                    return
                if kind == "infeasible":
                    verdict = str(payload)
                    break
                nm_cur = self._pool.get(tuple(payload))  # spillback
                attempt += 1
            if verdict is None:
                verdict = "too many spillbacks"
            with self._lock:
                ks = self._ltab.get(key)
                if ks is not None:
                    try:
                        ks.queue.remove(task_hex)
                        entry.in_key_queue = False
                    except ValueError:
                        pass
            self._fail_task(task_hex, "SCHEDULING_FAILED", verdict,
                            retry=False)
            # loop: the rest of the queue gets its own verdict

    def _kick_key(self, key: bytes) -> None:
        """Ensure lease requests cover the key's queued work."""
        self._maybe_request_leases(key)

    def _on_lease_granted(self, lease_id: str, task_id: TaskID,
                          worker_address: Tuple[str, int],
                          worker_id: str, node_id: str,
                          nm_address: Optional[Tuple[str, int]] = None
                          ) -> None:
        with self._lock:
            fresh = self._ltab.note_grant(lease_id)
            named = self.tasks.get(task_id.hex())
        if not fresh:
            # at-least-once delivery: the NM re-queues a lease whose
            # reply failed transiently, but the first delivery may have
            # landed (reply lost after processing) and already done the
            # slot/park/lease bookkeeping — hand the duplicate straight
            # back instead of corrupting the counts
            self._return_lease(lease_id, None, nm_address=nm_address)
            return
        key = named.sched_key if named is not None else None
        if key is None:
            # Unknown task (e.g. owner restarted): just hand it back.
            self._return_lease(lease_id, named, nm_address=nm_address)
            return
        with self._lock:
            ks = self._ltab.state(key)
            self._ltab.release_slot(ks, event="slot_granted")
            # signed: may beat the request's own "queued" reply
            self._ltab.unpark(ks, tuple(nm_address) if nm_address
                              else None)
            self._ltab.add_lease(
                ks, lease_id, (tuple(worker_address),
                               tuple(nm_address) if nm_address
                               else None, node_id))
        # The grant names the task whose spec rode the request, but any
        # queued task of the same key may run on it (reference
        # OnWorkerIdle drains the SchedulingKey queue).
        self._push_on_lease(key, lease_id)
        # Keep one request in flight while backlog remains — on a THREAD:
        # this handler runs inside the NM's blocking cw_lease_granted
        # call, and a synchronous nm.call back from here can three-way
        # deadlock on the shared per-address RpcClient locks (owner
        # handler waits NM, NM's next grant waits the client lock our
        # caller holds).
        with self._lock:
            ks2 = self._sched_keys.get(key)
            backlog = ks2 is not None and bool(ks2.queue)
        if backlog:
            threading.Thread(target=self._kick_key, args=(key,),
                             daemon=True, name="lease-kick").start()

    def _on_lease_granted_batch(self, grants: List[Dict[str, Any]]) -> None:
        """Grouped grant replies from one NM dispatch pass: each element
        runs the full singleton handler (note_grant's dedup ring makes a
        replayed batch element a returned duplicate, not a double
        grant)."""
        for g in grants:
            self._on_lease_granted(**g)

    def ownership_snapshot(self, object_id: Optional[str] = None,
                           limit: int = 200) -> Dict[str, Any]:
        """This process's ownership-protocol view: live RefState rows
        (every object with a live claim), per-scheduling-key LeaseState
        summaries, and the transition ring's tail — the wire form
        behind `ray_tpu ownership` / /api/ownership / util.state."""
        with self._lock:
            if object_id:
                keys = {h for h in (set(self.objects)
                                    | set(self.local_refs)
                                    | set(self.arg_pins)
                                    | set(self.borrower_pins)
                                    | set(self._replica_leases)
                                    | set(self.borrowed))
                        if h.startswith(object_id)}
                objs = [self._own.describe(h) for h in sorted(keys)]
            else:
                objs = self._own.live_objects()
            lease_keys = self._ltab.summary()
            running = {lid: sorted(h[:16] for h in hs)
                       for lid, hs in self._lease_running.items()}
            ttl_count = len(self._ttl_pins)
        snap = _ownership.ring().snapshot(
            key_prefix=object_id or None, limit=limit)
        return {
            "proc_uid": _spans.PROC_UID,
            "pid": os.getpid(),
            "label": _spans.process_label(),
            "node_id": self.node_id_hex,
            "worker_id": self.worker_id.hex(),
            "mode": self.mode,
            "wall_time": time.time(),
            "objects": objs,
            "lease_keys": lease_keys,
            "running_leases": running,
            "ttl_pins": ttl_count,
            "transitions": snap["transitions"],
            "anomalies": snap["anomalies"],
        }

    # Tasks pushed-but-incomplete per lease: 2 = the worker always has
    # the next task queued locally when it finishes one, so the owner's
    # done→push round trip leaves the worker's critical path (the
    # reference worker submit queues give the same pipelining). The
    # worker executes normal tasks on ONE thread, so depth never
    # over-commits the lease's resources.
    LEASE_PIPELINE_DEPTH = 2

    def _shm_send(self, addr, peer_node_id, method: str,
                  kwargs: Dict[str, Any]) -> bool:
        """Try the same-node shm ring to the peer process at `addr`;
        False means not eligible / ring or arena full and the caller
        must use the socket path (the message was NOT enqueued). A
        doorbell send failure propagates — that is the same dead-peer
        signal a socket one-way raises."""
        if self._shutdown or not Config.shm_task_channel \
                or not peer_node_id or peer_node_id != self.node_id_hex:
            return False
        key = tuple(addr)
        s = self._shm_senders.get(key)
        if s is None:
            # the ring file lives next to the node's store arena — its
            # directory doubles as "the shared-memory place on this
            # node"; no arena means no shm fast path
            arena = self.store.shared_arena()
            if arena is None:
                return False
            with self._shm_lock:
                s = self._shm_senders.get(key)
                if s is None:
                    try:
                        s = _shm.Sender(
                            os.path.dirname(arena.path),
                            f"{self.worker_id.hex()[:12]}-{key[1]}",
                            int(Config.shm_ring_bytes),
                            doorbell=lambda path, _a=key:
                                self._pool.get(_a).send_oneway(
                                    "shm_doorbell", path=path))
                    except OSError:
                        return False
                    self._shm_senders[key] = s
        try:
            # chaos client hook: drop_connection / partition rules fire
            # on ring sends exactly as they would on the socket path
            # (ConnectionLost propagates to the same call sites)
            chaos_lib.on_client_call(method, key)
            s.send(method, kwargs)
            return True
        except _shm.ShmUnavailable:
            return False

    def _push_on_lease(self, key: bytes, lease_id: str,
                       fallback_entry: Optional[_TaskEntry] = None
                       ) -> None:
        """Keep the leased worker's local queue primed (up to
        LEASE_PIPELINE_DEPTH in-flight tasks); return the lease when the
        key's queue is drained and nothing is in flight.

        All lease-state reads and writes for one push happen under ONE
        lock acquisition: a split check/increment would race concurrent
        decrements from _settle_lease_slot (lost update → the drained
        lease is never returned) and concurrent pushers (over-depth)."""
        while True:
            with self._lock:
                ks = self._ltab.get(key)
                info = ks.leases.get(lease_id) if ks is not None else None
                inflight = ks.lease_inflight.get(lease_id, 0) \
                    if ks is not None else 0
                if info is None:
                    task = None
                    action = "return_untracked" if inflight == 0 else \
                        "noop"
                elif inflight >= self.LEASE_PIPELINE_DEPTH:
                    task = None
                    action = "noop"
                else:
                    worker_address, nm_addr, node_id = info
                    # pop the next live queued task (inline: same lock).
                    # When pipelining BEHIND a running task (inflight >=
                    # 1), never pick a task that PRODUCES a pending arg
                    # of anything running on this lease: the runner may
                    # be blocked in get() on exactly that object, and
                    # normal tasks execute on one thread — queueing the
                    # producer behind its blocked consumer deadlocks the
                    # worker permanently (found by the ownership
                    # fuzzer's kill schedules via retry re-ordering).
                    # Skipped candidates keep their queue position; a
                    # fresh lease (the enqueue path keeps request slots
                    # covering the backlog) runs them elsewhere.
                    unsafe_producers: set = set()
                    if inflight > 0:
                        # TRANSITIVE closure over pending args: the
                        # runner may wait X <- E <- F, and pushing F
                        # behind it deadlocks just as surely as pushing
                        # E (walk bounded by live dependency chains)
                        frontier = list(
                            self._lease_running.get(lease_id, ()))
                        seen_t = set(frontier)
                        while frontier:
                            re_ = self.tasks.get(frontier.pop())
                            if re_ is None:
                                continue
                            for aid in re_.spec.arg_object_refs:
                                if self.objects.get(
                                        aid.hex(),
                                        (None,))[0] != PENDING:
                                    continue
                                p = aid.task_id().hex()
                                if p not in seen_t:
                                    seen_t.add(p)
                                    unsafe_producers.add(p)
                                    frontier.append(p)
                    task = None
                    skipped: List[str] = []
                    while ks.queue:
                        h = ks.queue.popleft()
                        e2 = self.tasks.get(h)
                        if e2 is not None and not e2.done \
                                and h in unsafe_producers:
                            skipped.append(h)
                            continue
                        if e2 is not None:
                            e2.in_key_queue = False
                        if e2 is not None and not e2.done:
                            task = (h, e2)
                            break
                    for h in reversed(skipped):
                        ks.queue.appendleft(h)
                    if task is None:
                        if inflight == 0:
                            self._ltab.drop_lease(ks, lease_id)
                            action = "return_drained"
                        else:
                            # skipped-only backlog: make sure lease
                            # requests still cover it so the skipped
                            # producers run on ANOTHER worker (their
                            # blocked consumer holds this one)
                            action = "kick" if skipped else "noop"
                    elif getattr(task[1].spec, "max_calls", 0) \
                            and inflight >= 1:
                        # no pipelining under max_calls recycling: the
                        # worker may exit right after the current task,
                        # losing a pre-queued one to the death-report
                        # path needlessly
                        ks.queue.appendleft(task[0])
                        task[1].in_key_queue = True
                        task = None
                        action = "noop"
                    else:
                        task_hex, entry = task
                        entry.node_id_hex = node_id
                        if nm_addr is not None:
                            entry.lease_node = nm_addr
                        self._ltab.incr_inflight(ks, lease_id, task_hex)
                        action = "push"
            if action == "return_untracked":
                # lease not tracked (already dropped): return via the
                # last task's lease_node so a remote NM gets it back
                self._return_lease(lease_id, fallback_entry)
                return
            if action == "return_drained":
                self._return_lease(lease_id, None, nm_address=nm_addr)
                return
            if action == "kick":
                threading.Thread(target=self._kick_key, args=(key,),
                                 daemon=True,
                                 name="pipeline-skip-kick").start()
                return
            if action != "push":
                return
            task_hex, entry = task
            self.task_events.record(task_hex, state="SCHEDULED",
                                    node_id=node_id)
            try:
                # one-way (reference PushTask is async): a push buffered
                # into a dying worker is failed by the NM's worker-death
                # report (the task enters _lease_running under the same
                # lock that verified the lease is live, so a report
                # arriving any time after sees it); send failures fail
                # over right here. Same-node workers take the shm ring
                # (zero syscalls while hot) with the socket as spill.
                if not self._shm_send(tuple(worker_address), node_id,
                                      "w_push_task",
                                      dict(spec=entry.spec,
                                           lease_id=lease_id)):
                    self._pool.get(tuple(worker_address)).send_oneway(
                        "w_push_task", spec=entry.spec, lease_id=lease_id)
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self._ltab.drop_lease(ks, lease_id)
                    self._ltab.drop_running_task(lease_id, task_hex)
                self._return_lease(lease_id, entry)
                self._fail_task(task_hex, "WORKER_DIED",
                                f"push to leased worker failed: {e}",
                                retry=True)
                return

    def _return_lease(self, lease_id: str, entry: Optional[_TaskEntry],
                      nm_address: Optional[Tuple[str, int]] = None,
                      reuse: bool = True) -> None:
        if nm_address is not None:
            nm_addr = tuple(nm_address)
        elif entry is not None and entry.lease_node:
            nm_addr = entry.lease_node
        else:
            nm_addr = self.nm_address
        # a LOST return strands the lease at the NM: the worker stays
        # "leased" and its resources held until process death — so
        # transient send failures retry with backoff (nm_return_worker
        # releases a lease id at most once, duplicates are no-ops).
        # One-way (not .call): this runs inside NM-driven handler
        # threads, where a blocking call back to the NM can three-way
        # deadlock on the shared per-address client locks.
        for delay_s in (0.0, 0.1, 0.4):
            if delay_s:
                time.sleep(delay_s)
            try:
                self._pool.get(nm_addr).send_oneway(
                    "nm_return_worker", lease_id=lease_id, reuse=reuse)
                return
            except Exception:  # noqa: BLE001 - retried; an NM that
                continue       # stays gone took its leases with it

    def _on_task_done(self, task_id: TaskID, results: List[Tuple],
                      lease_id: Optional[str] = None,
                      dynamic_children: Optional[List[Tuple]] = None,
                      worker_exiting: bool = False,
                      nested_refs: Optional[List[Tuple]] = None) -> None:
        h = task_id.hex()
        with self._lock:
            entry = self.tasks.get(h)
            duplicate = entry is None or entry.done
            retrying = False
            if (not duplicate and results and not dynamic_children
                    and entry.retries_left > 0
                    and entry.spec.task_type == TaskType.NORMAL_TASK
                    and getattr(entry.spec, "retry_exceptions", False)
                    and all(r and r[0] == ERROR for r in results)):
                # application-error retry (reference
                # TaskManager::RetryTaskIfPossible with retry_exceptions,
                # task_manager.cc:869): only RayTaskError (user code
                # raised) retries — cancellation/system errors don't.
                try:
                    err0 = pickle.loads(results[0][1])
                except Exception:  # noqa: BLE001
                    err0 = None
                if isinstance(err0, exc.RayTaskError):
                    entry.retries_left -= 1
                    retrying = True
            if not duplicate and not retrying:
                entry.done = True
                # submit-side backpressure accounting (max_pending_calls)
                self._decr_actor_pending_locked(entry)
                # dynamic-return children become owned objects of ours,
                # registered before the generator handle resolves so a
                # get() of a child ref never races its registration.
                # FREED children stay freed: a consumer that already
                # dropped its ref must not have the batch re-report
                # resurrect the location (the RefState machine rejects
                # the FREED->ready edge).
                for oid, loc in (dynamic_children or []):
                    if self.objects.get(oid.hex(),
                                        (PENDING,))[0] != FREED:
                        self._own.set_location(oid.hex(), tuple(loc),
                                               event="dynamic_child")
                    ev = self.object_events.pop(oid.hex(), None)
                    if ev is not None:  # recovery getters waiting
                        ev.set()
        if retrying:
            if lease_id is not None:
                self._settle_lease_slot(entry, lease_id, worker_exiting)
            logger.warning(
                "retrying task %s after application error, %d retries "
                "left", entry.spec.function_name, entry.retries_left)
            threading.Thread(target=self._enqueue_for_lease,
                             args=(entry.spec.task_id.hex(), entry),
                             daemon=True).start()
            return
        if duplicate:
            # Late/duplicate completion (e.g. after cancel or retry): the
            # first writer won; settle the lease slot that rode in.
            if lease_id is not None:
                self._settle_lease_slot(entry, lease_id, worker_exiting)
            return
        if nested_refs and entry.return_ids:
            # ObjectRefs embedded in the result: register borrows with
            # their owners NOW (the producing worker's pins are about to
            # lapse); released when the ENCLOSING return object frees
            # (reference ReferenceCounter contained-ref accounting).
            for oid, per in zip(entry.return_ids, nested_refs):
                if per:
                    self._register_nested_borrows(oid.hex(), per)
        for oid, loc in zip(entry.return_ids, results):
            with self._lock:
                # keep location unless already freed
                if self.objects.get(oid.hex(), (PENDING,))[0] != FREED:
                    self._own.set_location(oid.hex(), tuple(loc),
                                           event="resolve")
                # pop, don't get: events are waiter-created and resolve
                # retires them — keeps the dict sized by objects being
                # actively waited on, not by every ref ever created
                ev = self.object_events.pop(oid.hex(), None)
                if ev is not None:
                    ev.set()
        self._free_refless_returns(entry)
        self._unpin_args(entry.spec.arg_object_refs)
        self.task_events.record(h, state="FINISHED", ts_finished=_ev_now())
        _count_task_outcome("finished")
        entry.wake_dynamic()  # wake streaming iterators: task over
        self._fire_done_callbacks([oid.hex() for oid in entry.return_ids])
        if lease_id is not None:
            self._settle_lease_slot(entry, lease_id, worker_exiting)

    def _on_task_done_batch(self, reports: List[Dict[str, Any]]) -> None:
        """Batched completion reports off a worker's report drainer:
        many finished tasks, one RPC. Each element is exactly a
        cw_task_done kwargs dict and runs the full singleton handler —
        entry.done dedup plus the lease machine's settle no-op make a
        replayed batch (idempotent resend after a send failure)
        harmless."""
        for r in reports:
            self._on_task_done(**r)

    def _free_refless_returns(self, entry: _TaskEntry) -> None:
        """Free-on-resolve: a result whose every ref died while the
        task was PENDING has no reachable holder left — the free check
        at last-ref drop saw PENDING and deferred "until completion",
        and completion (success OR failure) must re-run it. Without
        this the result — and, for successes, the eager nested borrows
        pinning objects at OTHER owners — leaks forever (found by the
        ownership fuzzer's drop schedules). Generator results free only
        when the handle is refless too: unreferenced children are
        otherwise still reachable through a live generator's handle."""
        with self._lock:
            handle_hex = entry.return_ids[0].hex() \
                if entry.return_ids else None
            generator = bool(entry.spec.dynamic_returns
                             or entry.dynamic_arrived)
            handle_refless = handle_hex is not None and \
                self.local_refs.get(handle_hex, 0) == 0 and \
                self.arg_pins.get(handle_hex, 0) == 0
            if not generator or handle_refless:
                victims = [oid.hex() for oid in entry.return_ids]
                victims += [c.hex()
                            for c in entry.dynamic_arrived.values()]
                for h2 in victims:
                    if self.local_refs.get(h2, 0) == 0 and \
                            self.arg_pins.get(h2, 0) == 0:
                        self._maybe_free_locked(h2)

    def _settle_lease_slot(self, entry: Optional[_TaskEntry],
                           lease_id: str, worker_exiting: bool) -> None:
        """One pushed task finished (or was superseded): free its
        pipeline slot, then either retire the lease (worker_exiting:
        max_calls recycling — the NM must not re-lease a process that's
        about to exit) or keep the leased worker primed / return it
        (reference direct_task_transport.cc:125 lease reuse)."""
        key = entry.sched_key if entry is not None else None
        task_hex = entry.spec.task_id.hex() if entry is not None else None
        with self._lock:
            self._ltab.settle_inflight(self._ltab.get(key), lease_id,
                                       task_hex)
        if worker_exiting:
            self._drop_lease(key, lease_id)
            self._return_lease(lease_id, entry, reuse=False)
            return
        if key is None:
            self._return_lease(lease_id, entry)
            return
        self._push_on_lease(key, lease_id, fallback_entry=entry)

    def _drop_lease(self, key: Optional[bytes], lease_id: str) -> None:
        """Forget a held lease (it is being returned/retired)."""
        with self._lock:
            ks = self._ltab.get(key)
            if ks is not None:
                self._ltab.drop_lease(ks, lease_id)

    def _on_dynamic_child(self, task_id: TaskID, child: ObjectID,
                          loc: Tuple) -> None:
        """Streaming generator child: register the object the moment the
        executor stores it so iterators see it before the task ends."""
        with self._lock:
            entry = self.tasks.get(task_id.hex())
            if entry is None:
                return
            if self.objects.get(child.hex(), (PENDING,))[0] != FREED:
                self._own.set_location(child.hex(), tuple(loc),
                                       event="dynamic_child")
            entry.dynamic_arrived[child.return_index()] = child
            entry.wake_dynamic()
            ev = self.object_events.pop(child.hex(), None)
        if ev is not None:
            ev.set()
        self._fire_done_callbacks([child.hex()])

    def _on_task_failed(self, task_id: TaskID, error_type: str,
                        message: str,
                        lease_id: Optional[str] = None) -> None:
        fail_hexes = [task_id.hex()]
        if lease_id is not None:
            # With lease reuse + pipelining, the tasks in flight on the
            # lease at failure time (running + queued in the dead
            # worker) may differ from the task the lease was granted
            # for — the lease→running map has the truth.
            with self._lock:
                running = self._ltab.pop_running(lease_id)
            if running:
                # SUBMISSION order, not hex order: the retries re-enter
                # the key queue in this order, and submission order is
                # topological for data dependencies — a dependent
                # re-queued ahead of its dependency can end up pipelined
                # behind it on one single-threaded worker and deadlock
                fail_hexes = sorted(
                    running,
                    key=lambda th: (self.tasks[th].submit_seq
                                    if th in self.tasks else 0))
            entry = self.tasks.get(fail_hexes[0])
            if entry is not None and entry.sched_key is not None:
                self._drop_lease(entry.sched_key, lease_id)
        for tid_hex in fail_hexes:
            self._fail_task(tid_hex, error_type, message, retry=True)

    def _fail_task(self, task_hex: str, error_type: str, message: str,
                   retry: bool) -> None:
        with self._lock:
            entry = self.tasks.get(task_hex)
            if entry is None or entry.done:
                return
            will_retry = retry and entry.retries_left > 0
            if will_retry:
                entry.retries_left -= 1
            else:
                entry.done = True
                self._decr_actor_pending_locked(entry)
        if will_retry:
            logger.warning("retrying task %s (%s: %s), %d retries left",
                           entry.spec.function_name, error_type, message,
                           entry.retries_left)
            threading.Thread(target=self._enqueue_for_lease,
                             args=(entry.spec.task_id.hex(), entry),
                             daemon=True).start()
            return
        if error_type == "WORKER_DIED":
            err: Exception = exc.WorkerCrashedError(message)
        elif error_type == "CANCELLED":
            err = exc.TaskCancelledError(message)
        else:
            err = exc.RaySystemError(f"{error_type}: {message}")
        blob = pickle.dumps(err)
        for oid in entry.return_ids:
            with self._lock:
                if self.objects.get(oid.hex(), (PENDING,))[0] != FREED:
                    self._own.set_location(oid.hex(), (ERROR, blob),
                                           event="fail")
                ev = self.object_events.pop(oid.hex(), None)
                if ev is not None:
                    ev.set()
        # same refless-free sweep as the success path: a failed
        # fire-and-forget task must not leak its (ERROR, blob) entry
        self._free_refless_returns(entry)
        self._unpin_args(entry.spec.arg_object_refs)
        self.task_events.record(task_hex, state="FAILED",
                                ts_finished=_ev_now(),
                                error=f"{error_type}: {message}"[:500])
        _count_task_outcome("failed")
        entry.wake_dynamic()
        self._fire_done_callbacks([oid.hex() for oid in entry.return_ids])

    # ------------------------------------------------------------------
    # Actor submission (reference direct_actor_task_submitter.h)
    # ------------------------------------------------------------------

    def create_actor(self, spec: TaskSpec, name: str = "",
                     namespace: str = "") -> None:
        spec.owner_node_id = self.node_id_hex
        self._pin_args(spec.arg_object_refs)
        with self._lock:
            self.actors[spec.actor_id.hex()] = _ActorState(
                actor_id=spec.actor_id)
        self._attach_trace(spec)
        spec.locality_hints, spec.arg_locations = \
            self._locality_info(spec.arg_object_refs)
        self._gcs.call("register_actor", spec=spec, name=name,
                       namespace=namespace)
        self.task_events.record(
            spec.task_id.hex(), state="SUBMITTED", ts_submitted=_ev_now(),
            name=f"{spec.function_name}.__init__", type="ACTOR_CREATION_TASK",
            job_id=spec.job_id.hex(), trace_id=spec.trace_id,
            parent_task_id=spec.parent_task_id)

    def attach_actor(self, actor_id: ActorID) -> None:
        """Track an actor we only hold a handle to (named/deserialized)."""
        with self._lock:
            if actor_id.hex() not in self.actors:
                self.actors[actor_id.hex()] = _ActorState(actor_id=actor_id)

    def actor_is_dead(self, actor_id: ActorID) -> bool:
        """Owner-side liveness peek (death pubsub keeps it fresh): a
        dict lookup, no RPC. Used by compiled DAGs to notice a cached
        actor died and fall back to the interpreted path."""
        with self._lock:
            st = self.actors.get(actor_id.hex())
            return bool(st is not None and st.dead)

    def actor_pending_calls(self, actor_id: ActorID) -> int:
        """Caller-side count of this actor's submitted-but-unfinished
        calls (reference max_pending_calls backpressure)."""
        with self._lock:
            return self._actor_pending.get(actor_id.hex(), 0)

    def _decr_actor_pending_locked(self, entry: "_TaskEntry") -> None:
        """Call under self._lock when an actor task reaches a terminal
        state — every terminal path must hit this or the caller's
        max_pending_calls budget leaks shut."""
        aid = entry.spec.actor_id
        if aid is not None and \
                entry.spec.task_type == TaskType.ACTOR_TASK:
            cnt = self._actor_pending.get(aid.hex(), 0)
            if cnt > 0:
                self._actor_pending[aid.hex()] = cnt - 1

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          function_key: str, args_blob: bytes,
                          arg_refs: List[ObjectID],
                          num_returns: int,
                          concurrency_group: str = "",
                          max_pending_calls: int = -1,
                          dynamic_returns: bool = False
                          ) -> List[ObjectRef]:
        spec = TaskSpec(
            task_id=TaskID.of(self.job_id), job_id=self.job_id,
            task_type=TaskType.ACTOR_TASK, function_key=function_key,
            function_name=method_name, args=self._intern_blob(args_blob),
            arg_object_refs=arg_refs, num_returns=num_returns,
            resources={}, owner_address=self.address,
            owner_worker_id=self.worker_id, actor_id=actor_id,
            actor_method_name=method_name,
            concurrency_group=concurrency_group)
        spec.owner_node_id = self.node_id_hex
        spec.dynamic_returns = dynamic_returns
        # before the spec becomes reachable by other threads: a queued
        # spec can be popped+pickled by an in-flight _resolve_actor the
        # moment the lock below releases
        self._attach_trace(spec)
        return_ids = [ObjectID.for_task_return(spec.task_id, i + 1)
                      for i in range(num_returns)]
        if Config.memory_callsite_capture and return_ids:
            self._note_callsite([oid.hex() for oid in return_ids])
        with self._lock:
            state = self.actors.get(actor_id.hex())
            if state is None:
                state = _ActorState(actor_id=actor_id)
                self.actors[actor_id.hex()] = state
            if state.dead:
                blob = pickle.dumps(
                    exc.ActorDiedError(actor_id.hex(), state.death_cause))
                for oid in return_ids:
                    self._own.set_location(oid.hex(), (ERROR, blob),
                                           event="actor_dead")
                return [ObjectRef(oid, self.address) for oid in return_ids]
            # backpressure bound checked ATOMICALLY with the increment:
            # an unlocked pre-check would let concurrent submitters
            # overshoot the budget together
            pending = self._actor_pending.get(actor_id.hex(), 0)
            if 0 <= max_pending_calls <= pending:
                raise exc.PendingCallsLimitExceeded(
                    f"actor {actor_id.hex()[:12]} already has {pending} "
                    f"pending calls from this caller "
                    f"(max_pending_calls={max_pending_calls})")
            spec.sequence_number = state.seq
            state.seq += 1
            for oid in return_ids:
                self._own.set_location(oid.hex(), (PENDING,),
                                       event="submit")
            self.tasks[spec.task_id.hex()] = _TaskEntry(
                spec=spec, retries_left=0, return_ids=return_ids)
            self._actor_pending[actor_id.hex()] = pending + 1
            addr = state.address
            if addr is None:
                state.queue.append(spec)
                need_resolve = not state.resolving
                state.resolving = True
            else:
                need_resolve = False
        # register the caller's refs BEFORE the push: a fast completion
        # must never observe local_refs == 0 and free a live result
        # (see submit_task)
        refs_out = [ObjectRef(oid, self.address) for oid in return_ids]
        self.task_events.record(
            spec.task_id.hex(), state="SUBMITTED", ts_submitted=_ev_now(),
            name=f"{method_name} [actor {actor_id.hex()[:8]}]",
            type="ACTOR_TASK", job_id=spec.job_id.hex(),
            trace_id=spec.trace_id, parent_task_id=spec.parent_task_id)
        self._pin_args(arg_refs)
        if addr is not None:
            self._push_actor_task(addr, spec)
        elif need_resolve:
            threading.Thread(target=self._resolve_actor,
                             args=(actor_id,), daemon=True).start()
        return refs_out

    def _push_actor_task(self, addr: Optional[Tuple[str, int]],
                         spec: TaskSpec) -> None:
        try:
            if addr is None:
                raise rpc_lib.ConnectionLost("actor address unknown")
            # one-way push (reference PushTask is async with an error
            # callback): send failures raise and re-resolve below; a
            # push lost in a dying actor's buffer is failed by the
            # death/incarnation bookkeeping (state.pushed) instead.
            # Same-node actors take the shm ring.
            with self._lock:
                st = self.actors.get(spec.actor_id.hex())
                peer_node = st.node_id_hex if st is not None else None
            if not self._shm_send(tuple(addr), peer_node, "w_push_task",
                                  dict(spec=spec)):
                self._pool.get(addr).send_oneway("w_push_task", spec=spec)
            with self._lock:
                state = self.actors[spec.actor_id.hex()]
                state.pushed[spec.task_id.hex()] = state.incarnation
        except Exception:  # noqa: BLE001
            # actor possibly restarting: invalidate and re-resolve
            if addr is not None:
                self._pool.invalidate(addr)
            with self._lock:
                state = self.actors[spec.actor_id.hex()]
                if state.address == addr:
                    state.address = None
                state.queue.append(spec)
                need = not state.resolving
                state.resolving = True
            if need:
                threading.Thread(target=self._resolve_actor,
                                 args=(spec.actor_id,), daemon=True).start()

    def _resolve_actor(self, actor_id: ActorID) -> None:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and not self._shutdown:
            try:
                info = self._gcs.call("get_actor_info",
                                      actor_id_hex=actor_id.hex())
            except Exception:  # noqa: BLE001
                time.sleep(0.2)
                continue
            if info is None:
                time.sleep(0.1)
                continue
            if info.state == "ALIVE" and info.address is not None:
                lost: List[TaskSpec] = []
                with self._lock:
                    state = self.actors[actor_id.hex()]
                    new_addr = tuple(info.address)
                    restarted = (state.last_address is not None
                                 and state.last_address != new_addr)
                    state.address = new_addr
                    state.last_address = new_addr
                    state.node_id_hex = info.node_id.hex() \
                        if info.node_id is not None else None
                    state.resolving = False
                    q, state.queue = state.queue, []
                    q.sort(key=lambda s: s.sequence_number)
                    if restarted:
                        state.incarnation += 1
                        # Tasks pushed to the dead incarnation are lost:
                        # fail them (at-most-once actor task semantics).
                        for thex, inc in list(state.pushed.items()):
                            if inc < state.incarnation:
                                entry = self.tasks.get(thex)
                                state.pushed.pop(thex, None)
                                if entry is not None and not entry.done:
                                    lost.append(entry.spec)
                        # Renumber the never-pushed queue from seq 0 for the
                        # fresh incarnation's reordering buffer.
                        for i, spec in enumerate(q):
                            spec.sequence_number = i
                        state.seq = len(q)
                blob = pickle.dumps(exc.ActorUnavailableError(
                    actor_id.hex(), "actor restarted; in-flight task lost"))
                for spec in lost:
                    self._on_task_done(spec.task_id,
                                       [(ERROR, blob)] * spec.num_returns)
                for spec in q:
                    # push to the freshly-resolved address, not the mutable
                    # state.address (a concurrent push failure may null it)
                    self._push_actor_task(new_addr, spec)
                return
            if info.state == "DEAD":
                self._mark_actor_dead(actor_id, info.death_cause)
                return
            time.sleep(0.1)
        self._mark_actor_dead(actor_id, "timed out resolving actor address")

    def _mark_actor_dead(self, actor_id: ActorID, cause: str) -> None:
        with self._lock:
            state = self.actors.get(actor_id.hex())
            if state is None:
                return
            state.dead = True
            state.death_cause = cause
            state.resolving = False
            q, state.queue = state.queue, []
        err = exc.ActorDiedError(actor_id.hex(), cause)
        blob = pickle.dumps(err)
        for spec in q:
            self._on_task_done(spec.task_id,
                               [(ERROR, blob)] * spec.num_returns)
        # fail any in-flight (pushed but unacked) tasks for this actor
        with self._lock:
            inflight = [e for e in self.tasks.values()
                        if e.spec.actor_id == actor_id and not e.done]
        for e in inflight:
            self._on_task_done(e.spec.task_id,
                               [(ERROR, blob)] * e.spec.num_returns)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._gcs.call("kill_actor", actor_id_hex=actor_id.hex(),
                       no_restart=no_restart)

    def cancel_task(self, ref: ObjectRef) -> None:
        with self._lock:
            entry = self.tasks.get(ref.task_id().hex())
        if entry is None or entry.done:
            return
        self._fail_task(ref.task_id().hex(), "CANCELLED", "ray.cancel",
                        retry=False)

    # ------------------------------------------------------------------
    # Owner-side handlers
    # ------------------------------------------------------------------

    def _on_get_object(self, oid_hex: str) -> Tuple:
        with self._lock:
            loc = self.objects.get(oid_hex)
        if loc is None:
            return ("unknown",)
        if loc[0] == PENDING:
            return (PENDING,)
        return loc

    def _on_wait_object(self, oid_hex: str, timeout: float = 30.0) -> Tuple:
        """Long-poll variant of cw_get_object (reference: the pubsub
        long-poll object-location channel, core_worker.proto:441): parks
        until the object resolves instead of making borrowers busy-poll."""
        deadline = time.monotonic() + min(timeout, 60.0)
        while True:
            with self._lock:
                loc = self.objects.get(oid_hex)
                if loc is not None and loc[0] == PENDING:
                    ev = self.object_events.setdefault(
                        oid_hex, threading.Event())
                else:
                    return loc if loc is not None else ("unknown",)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return (PENDING,)
            ev.wait(timeout=min(remaining, 1.0))

    def _on_add_ref(self, oid_hex: str,
                    borrower: Optional[Tuple[str, int]] = None) -> None:
        with self._lock:
            if borrower is not None:
                # borrower registration and its backing arg pin move
                # together inside the table (borrower_pins <= arg_pins
                # holds by construction)
                self._own.add_borrower(oid_hex, tuple(borrower))
            else:
                self._own.pin_arg(oid_hex, event="pin_arg")

    def _on_remove_ref(self, oid_hex: str,
                       borrower: Optional[Tuple[str, int]] = None) -> None:
        with self._lock:
            if borrower is not None:
                n = self._own.release_borrower(oid_hex, tuple(borrower))
                if n is None:
                    # unmatched (this borrower holds no pin here — e.g.
                    # the dead-borrower sweep already released it, or a
                    # duplicate release): decrementing arg_pins anyway
                    # would free a pin some OTHER claimant holds. The
                    # table recorded the anomaly; drop the release.
                    return
            else:
                n = self._own.unpin_arg(oid_hex, strict=False,
                                        event="unpin_arg")
            if n <= 0 and self.local_refs.get(oid_hex, 0) == 0:
                self._maybe_free_locked(oid_hex)

    def _on_claims(self, oid_hexes: List[str]) -> Dict[str, bool]:
        with self._lock:
            return self._own.claims(list(oid_hexes))

    def _sweep_dead_borrowers(self) -> None:
        """Reconcile borrower pins against reality: pins of DEAD
        borrowers are dropped outright; LIVE borrowers are asked which
        pinned objects they still claim (cw_claims) and disclaimed pins
        are released — the safety net for a release whose sends were
        all lost (without it a transient outage leaks the pin at a live
        owner forever). Safe against in-flight releases: a late
        cw_remove_ref for a reconciled pin is dropped as unmatched."""
        with self._lock:
            by_addr: Dict[Tuple[str, int], List[str]] = {}
            for h, by in self.borrower_pins.items():
                for a in by:
                    by_addr.setdefault(a, []).append(h)
        for addr, oids in by_addr.items():
            claims: Optional[Dict[str, bool]] = None
            dead = False
            try:
                claims = self._pool.get(addr).call("cw_claims",
                                                   oid_hexes=oids)
            except Exception:  # noqa: BLE001
                self._pool.invalidate(addr)
                try:
                    self._pool.get(addr).call("cw_ping")
                except Exception:  # noqa: BLE001
                    dead = True
            if dead:
                logger.info("borrower %s died; releasing its pins", addr)
                with self._lock:
                    for oid_hex, n in self._own.sweep_borrower(addr):
                        if n <= 0 and \
                                self.local_refs.get(oid_hex, 0) == 0:
                            self._maybe_free_locked(oid_hex)
                continue
            if not isinstance(claims, dict):
                continue  # borrower alive but claims unavailable
            disclaimed = [h for h in oids if claims.get(h) is False]
            if not disclaimed:
                continue
            logger.info("borrower %s disclaims %d pinned object(s); "
                        "reconciling lost release(s)", addr,
                        len(disclaimed))
            with self._lock:
                for oid_hex, n in self._own.sweep_borrower(
                        addr, only=disclaimed,
                        event="borrower_disclaimed"):
                    if n <= 0 and self.local_refs.get(oid_hex, 0) == 0:
                        self._maybe_free_locked(oid_hex)

    def _on_node_event(self, message: Any) -> None:
        """GCS "node" channel: fail (and retry) in-flight normal tasks
        whose lease lives on a node that just died — both tasks granted to
        workers there (node_id match) and tasks still queued at its node
        manager (lease_node match). Actor tasks resolve through the GCS
        actor-restart path instead."""
        try:
            event, info = message
        except Exception:  # noqa: BLE001
            return
        if event != "DEAD":
            return
        dead_hex = info.node_id.hex()
        dead_nm = tuple(info.address) if info.address else None
        kick_keys = set()
        with self._lock:
            lost = [e for e in self.tasks.values()
                    if not e.done and e.spec.actor_id is None
                    and (e.node_id_hex == dead_hex
                         or (e.lease_node is not None
                             and e.lease_node == dead_nm))]
            # Lease requests "queued" at the dead NM never get their
            # grants: reset the slot count so the key's queue can
            # re-request at a live NM instead of stalling forever
            # (over-counting self-heals — surplus grants with an empty
            # queue hand their lease straight back).
            for e in lost:
                ks = self._ltab.get(e.sched_key)
                if ks is not None and e.lease_node == dead_nm:
                    self._ltab.reset_slots(ks, event="node_death_reset")
                    # surgical: only the dead NM's parked entry dies —
                    # counts parked at live NMs (and their pending
                    # grants) keep balancing each other
                    self._ltab.drop_parked(ks, dead_nm)
                    if ks.queue:
                        kick_keys.add(e.sched_key)
            # Sweep EVERY key's parked_at for the dead NM, not only the
            # lost entries' keys: a request can sit parked there with no
            # task entry pointing at it (the task completed via another
            # NM's grant, or a later attempt overwrote lease_node).
            # Those requests never grant — without releasing their
            # slots the key stalls holding in_flight == parked, which
            # the watchdog's lease_slot_balance probe reads as balanced.
            # A negative bucket (grant outraced its "queued" reply) is
            # dropped without a release: that slot was already returned
            # by the grant, and the reply that would rebalance it died
            # with the NM.
            if dead_nm is not None:
                for key, ks in self._sched_keys.items():
                    n = self._ltab.drop_parked(ks, dead_nm)
                    if n > 0:
                        self._ltab.release_slots(
                            ks, n, event="dead_nm_slot_release")
                        if ks.queue:
                            kick_keys.add(key)
        for e in lost:
            self._fail_task(e.spec.task_id.hex(), "WORKER_DIED",
                            f"node {dead_hex[:12]} died", retry=True)
        for key in kick_keys:
            threading.Thread(target=self._kick_key, args=(key,),
                             daemon=True, name="node-death-kick").start()

    def _on_actor_event(self, message: Any) -> None:
        try:
            event, info = message
        except Exception:  # noqa: BLE001
            return
        with self._lock:
            state = self.actors.get(info.actor_id.hex())
        if state is None or state.dead:
            return  # not an actor we hold a handle to
        if event == "DEAD":
            self._mark_actor_dead(info.actor_id, info.death_cause)
        elif event == "RESTARTING":
            with self._lock:
                state.address = None
                need = not state.resolving
                state.resolving = True
            if need:
                threading.Thread(target=self._resolve_actor,
                                 args=(info.actor_id,), daemon=True,
                                 name="actor-rebind").start()

    def _on_pubsub_push(self, channel: str, token: str, message: Any) -> None:
        cb = self._subscriptions.get((channel, token))
        if cb is not None:
            try:
                cb(message)
            except Exception:  # noqa: BLE001
                logger.exception("pubsub callback failed")

    def subscribe(self, channel: str, callback: Any) -> str:
        import uuid
        token = uuid.uuid4().hex
        self._subscriptions[(channel, token)] = callback
        self._gcs.call("subscribe", channel=channel, address=self.address,
                       token=token)
        return token

    def unsubscribe(self, channel: str, token: str) -> None:
        """Drop a subscription end to end: local callback AND the GCS's
        (address, token) entry — a short-lived subscriber (follow-mode
        log streaming) must not keep the publish fan-out paying for it
        forever."""
        self._subscriptions.pop((channel, token), None)
        try:
            self._gcs.call("unsubscribe", channel=channel,
                           address=self.address, token=token)
        except Exception:  # noqa: BLE001 - GCS gone; entry dies with it
            pass

    def _on_can_exit(self) -> bool:
        """May this worker exit without stranding objects? False while
        anyone holds a pin on objects we own (a driver's ref to a value
        this worker put() makes us the owner — killing us would lose it;
        reference: the raylet's cooperative idle Exit RPC that the core
        worker declines while it owns in-scope objects)."""
        with self._lock:
            return not self.arg_pins and not self.borrower_pins

    def _on_kill_self(self) -> str:
        threading.Timer(0.05, lambda: os._exit(0)).start()
        return "dying"

    # ------------------------------------------------------------------

    def shutdown(self) -> None:
        self._shutdown = True
        self._lease_req_q.put(None)
        _metrics_plane.unregister_sampler("core_worker")
        _metrics_plane.unregister_snapshot_extra(
            _memory_plane.PROC_DIGEST_KEY)
        _profiler.sampler().stop()
        # Drain queued borrow releases before tearing the process down so a
        # clean exit doesn't strand pins at owners.
        try:
            self._drain_local_frees()
        except Exception:  # noqa: BLE001 - store may already be gone
            pass
        while True:
            try:
                item = self._borrow_release_queue.get_nowait()
            except queue.Empty:
                break
            if item is None or len(item) == 1:
                continue
            try:
                if item[0] == "store_delete":
                    self._pool.get(item[1]).send_oneway(
                        "store_delete", object_ids=[item[2]])
                else:
                    owner_addr, oid_hex = item[:2]
                    self._pool.get(owner_addr).call(
                        "cw_remove_ref", oid_hex=oid_hex,
                        borrower=self.address)
            # best-effort release during shutdown: the owner may already
            # be gone, and there is nothing left to free on our side
            except Exception:  # noqa: BLE001  graftlint: disable=RT008
                pass
        self._borrow_release_queue.put(None)
        # release reader leases on pulled replicas so the local store can
        # evict them (a SIGKILLed process leaks its leases until the
        # store itself is torn down — graceful exits should not)
        with self._lock:
            leases = self._own.drain_replica_leases()
        for h, n in leases.items():
            try:
                self.store.unpin(h, count=n)
            # best-effort during teardown: the store may already be gone
            except Exception:  # noqa: BLE001  graftlint: disable=RT008
                pass
        try:
            self.task_events.stop()
        except Exception:  # noqa: BLE001 - teardown; event sink may be gone
            pass
        if self._shm_rx is not None:
            self._shm_rx.stop()
        with self._shm_lock:
            senders, self._shm_senders = dict(self._shm_senders), {}
        for s in senders.values():
            try:
                s.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        self.server.stop()
        self.store.close()
        self._pool.close_all()
        self._gcs.close()
        self._nm.close()


class _Executor:
    """Task execution engine inside worker processes.

    reference parity: CoreWorker::ExecuteTask (core_worker.cc:2598) +
    scheduling queues (normal_scheduling_queue.h:32, actor_scheduling_queue
    .h:40 for per-caller seq ordering) + ConcurrencyGroupManager thread pools
    (thread_pool.h:36).
    """

    def __init__(self, cw: CoreWorker):
        self.cw = cw
        self.actor_instance: Any = None
        self.actor_id: Optional[ActorID] = None
        self._queue: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        self._lock = TracedLock("executor")
        # per-owner seq reordering
        self._next_seq: Dict[str, int] = {}
        self._buffer: Dict[str, Dict[int, TaskSpec]] = {}
        self._cancelled: set = set()
        # task_ids already queued via push_task: makes a retried
        # w_push_task (rpc reply lost after a successful send) a no-op
        # instead of a double execution. Bounded — a retry lands within
        # seconds, not after thousands of intervening pushes.
        self._pushed_ids: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._threads: List[threading.Thread] = []
        # named concurrency groups: group -> dedicated task queue
        self._group_queues: Dict[str, "queue.Queue"] = {}
        # per-group running-execution counts; queued + running is the
        # server-side "ongoing" depth (reference: replica queue length
        # probed by serve's PowerOfTwoChoicesReplicaScheduler,
        # router.py:893)
        self._running: Dict[str, int] = {}
        # per-function execution counts for max_calls worker recycling
        self._calls_by_fn: Dict[str, int] = {}
        # which concurrency group the current thread serves (threads are
        # group-pinned for life) + per-group thread-pool widths, for
        # spare-capacity accounting
        self._group_tls = threading.local()
        self._default_threads = 0
        self._group_widths: Dict[str, int] = {}
        # done-report drainer: the common-path cw_task_done one-ways
        # queue here and ship in owner-grouped batches (one frame — or
        # one shm ring slot — for N completions) instead of one socket
        # write per task. idle flags the drainer as between batches so
        # the pre-exit flush can tell "queue empty" from "report still
        # in the drainer's hands".
        self._report_q: "queue.Queue" = queue.Queue()
        self._report_idle = threading.Event()
        self._report_idle.set()
        threading.Thread(target=self._report_drain_loop, daemon=True,
                         name="done-report-drain").start()
        self._spawn_exec_threads(1)

    def has_spare_capacity(self) -> bool:
        """True while at least one executor thread of the CALLING
        thread's concurrency group is idle — then this actor can still
        field the calls a cycle peer would send here, so a blocking get
        does not make it a hard node in the waits-for graph. Counted per
        group: an idle thread of a different group can't serve this
        group's queue."""
        group = getattr(self._group_tls, "group", "")
        with self._lock:
            running = self._running.get(group, 0)
            width = self._group_widths.get(group, 1) if group \
                else self._default_threads
        return running < width

    def queue_depth(self, group: str = "") -> int:
        """Queued + currently-executing tasks for one concurrency group
        (default group when unnamed). Readable from a DIFFERENT group's
        thread even while this group is saturated."""
        q = self._group_queues.get(group, self._queue) if group \
            else self._queue
        with self._lock:
            running = self._running.get(group, 0)
        return q.qsize() + running

    def total_queue_depth(self) -> int:
        """Queued + executing across the default AND every named
        concurrency group — the saturation signal the metrics plane
        exports (a replica saturated on one named group must not read
        as idle)."""
        with self._lock:
            groups = list(self._group_queues)
        return self.queue_depth("") + sum(
            self.queue_depth(g) for g in groups)

    def _spawn_exec_threads(self, n: int) -> None:
        while len(self._threads) < n:
            t = threading.Thread(target=self._exec_loop, daemon=True,
                                 name=f"exec-{len(self._threads)}")
            t.start()
            self._threads.append(t)
            self._default_threads += 1

    def _ensure_aio_loop(self):
        """Lazily start the actor's asyncio loop thread."""
        import asyncio
        loop = getattr(self, "_aio_loop", None)
        if loop is not None:
            return loop
        with self._lock:
            loop = getattr(self, "_aio_loop", None)
            if loop is None:
                loop = asyncio.new_event_loop()
                t = threading.Thread(target=loop.run_forever,
                                     daemon=True, name="actor-aio-loop")
                t.start()
                self._aio_loop = loop
        return self._aio_loop

    def push_task(self, spec: TaskSpec, lease_id: Optional[str] = None) -> str:
        if spec.task_type == TaskType.ACTOR_TASK:
            owner = spec.owner_worker_id.hex()
            with self._lock:
                buf = self._buffer.setdefault(owner, {})
                buf[spec.sequence_number] = spec
                nxt = self._next_seq.setdefault(owner, 0)
                while nxt in buf:
                    s = buf.pop(nxt)
                    s._lease_id = None  # type: ignore[attr-defined]
                    # route by concurrency group: releases stay in
                    # per-owner order, but a saturated group never
                    # blocks calls destined for other groups
                    # (reference concurrency_group_manager.h)
                    self._group_queues.get(
                        getattr(s, "concurrency_group", "") or "",
                        self._queue).put(s)
                    nxt += 1
                self._next_seq[owner] = nxt
        else:
            if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                # duplicate-safe so the NM's creation push can sit in the
                # rpc retry set: a reply lost AFTER a successful send is
                # re-sent, and the second copy must queue nothing. Safe
                # for creation ONLY — an actor restart lands on a fresh
                # worker process, so the same creation task_id never
                # legitimately arrives here twice. (NORMAL_TASK retries
                # DO reuse the task_id on a possibly-reused worker, and
                # ACTOR_TASK pushes are already guarded by the per-owner
                # sequence cursor above.)
                tid = spec.task_id.hex()
                with self._lock:
                    if tid in self._pushed_ids:
                        return "ok"
                    self._pushed_ids[tid] = None
                    while len(self._pushed_ids) > 64:
                        self._pushed_ids.popitem(last=False)
            spec._lease_id = lease_id  # type: ignore[attr-defined]
            if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                self._spawn_exec_threads(max(1, spec.max_concurrency))
                for group, width in (spec.concurrency_groups
                                     or {}).items():
                    self._ensure_group(group, width)
            self._queue.put(spec)
        return "ok"

    def _ensure_group(self, group: str, width: int) -> None:
        """Dedicated queue + thread pool per named concurrency group."""
        with self._lock:
            if group in self._group_queues:
                return
            q: "queue.Queue" = queue.Queue()
            self._group_queues[group] = q
            self._group_widths[group] = max(1, width)
        for i in range(max(1, width)):
            t = threading.Thread(target=self._exec_loop, args=(q, group),
                                 daemon=True,
                                 name=f"exec-{group}-{i}")
            t.start()
            self._threads.append(t)

    def cancel_task(self, task_id_hex: str) -> None:
        self._cancelled.add(task_id_hex)

    def _exec_loop(self, q: Optional["queue.Queue"] = None,
                   group: str = "") -> None:
        q = q if q is not None else self._queue
        self._group_tls.group = group
        while True:
            spec = q.get()
            if spec is None:
                return
            with self._lock:
                self._running[group] = self._running.get(group, 0) + 1
            try:
                self._execute(spec)
            except Exception:  # noqa: BLE001
                logger.exception("executor crashed on %s", spec.function_name)
            finally:
                with self._lock:
                    self._running[group] = self._running.get(group, 1) - 1

    def _resolve_args(self, spec: TaskSpec) -> Tuple[tuple, dict]:
        args, kwargs = ser.unpack(memoryview(spec.args))
        # Top-level ObjectRef args are resolved to values (reference
        # semantics: only top-level args are awaited+inlined).
        def resolve(x: Any) -> Any:
            if isinstance(x, ObjectRef):
                return self.cw.get([x], timeout=None)[0]
            return x
        return tuple(resolve(a) for a in args), \
            {k: resolve(v) for k, v in kwargs.items()}

    def _execute(self, spec: TaskSpec) -> None:
        cw = self.cw
        will_exit = False  # max_calls recycling decision (see below)
        if spec.task_id.hex() in self._cancelled:
            self._report_error(spec, exc.TaskCancelledError(spec.function_name))
            return
        # max_calls counts EVERY execution — failing and generator tasks
        # included (the recycle exists for leaky native libs, which leak
        # on errors too). The exit decision itself happens at report time.
        recycle_candidate = False
        if spec.task_type == TaskType.NORMAL_TASK and spec.max_calls > 0:
            with self._lock:
                n = self._calls_by_fn.get(spec.function_key, 0) + 1
                self._calls_by_fn[spec.function_key] = n
            recycle_candidate = n >= spec.max_calls

        def decide_exit() -> bool:
            # _on_can_exit covers pins registered so far; a ref returned
            # BY THIS task isn't borrowed yet when we exit — losing such
            # an owner matches the reference's owner-failure semantics
            # for worker-owned objects.
            return recycle_candidate and cw._on_can_exit()
        cw.set_current_task(spec.task_id)
        cw.set_current_trace(spec.trace_id)
        # manual begin/end (the finally below clears the trace context,
        # so a `with` wrapping it would record a trace-less span)
        _task_span = _spans.start_span("task.run",
                                       name=spec.function_name,
                                       task_id=spec.task_id.hex())
        cw.task_events.record(spec.task_id.hex(), state="RUNNING",
                              ts_running=_ev_now(),
                              worker_id=cw.worker_id.hex(),
                              node_id=cw.node_id_hex)
        # expose the task's placement group for get_current_placement_group
        # (reference: worker.placement_group_id via TaskSpec capture); an
        # actor keeps its creation PG for all subsequent method calls
        if spec.placement_group_id is not None:
            cw.current_placement_group_id = spec.placement_group_id
        try:
            results: List[Tuple] = []
            try:
                if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                    cls = cw.import_function(spec.function_key)
                    args, kwargs = self._resolve_args(spec)
                    # kill_worker chaos rules select by actor class;
                    # tagged before __init__ runs so pushes dispatched
                    # during a slow constructor already match
                    from ray_tpu_torch._private import chaos as chaos_lib
                    chaos_lib.client().set_actor_class(spec.function_name)
                    # profiler samples carry the actor identity
                    # (process-wide: one actor instance per worker)
                    _profiler.set_process_actor(spec.actor_id.hex())
                    self.actor_instance = cls(*args, **kwargs)
                    self.actor_id = spec.actor_id
                    cw._gcs.call("report_actor_alive",
                                 actor_id_hex=spec.actor_id.hex(),
                                 address=cw.address,
                                 node_id_hex=cw.node_id_hex)
                    values: List[Any] = [None] * spec.num_returns
                elif spec.task_type == TaskType.ACTOR_TASK:
                    if self.actor_instance is None:
                        raise exc.RaySystemError("actor not initialized")
                    method = getattr(self.actor_instance,
                                     spec.actor_method_name)
                    args, kwargs = self._resolve_args(spec)
                    out = method(*args, **kwargs)
                    if inspect.iscoroutine(out):
                        # async actor (reference fiber.h / asyncio
                        # actors): coroutines run on one shared event
                        # loop so awaits interleave; up to
                        # max_concurrency calls (exec threads) can be
                        # in flight at once
                        import asyncio
                        out = asyncio.run_coroutine_threadsafe(
                            out, self._ensure_aio_loop()).result()
                    if spec.dynamic_returns:
                        # generator ACTOR method (streaming responses):
                        # same child-object protocol as generator tasks
                        self._emit_dynamic_children(spec, out,
                                                    decide_exit)
                        return
                    values = self._split_returns(out, spec.num_returns)
                elif spec.dynamic_returns:
                    # generator task (reference dynamic returns): store
                    # each yielded value as its own object; the declared
                    # return resolves to the list of child refs. Each
                    # child is ALSO reported as it lands so streaming
                    # consumers iterate before the task finishes.
                    fn = cw.import_function(spec.function_key)
                    args, kwargs = self._resolve_args(spec)
                    self._emit_dynamic_children(
                        spec, fn(*args, **kwargs), decide_exit)
                    return
                else:
                    fn = cw.import_function(spec.function_key)
                    args, kwargs = self._resolve_args(spec)
                    out = fn(*args, **kwargs)
                    values = self._split_returns(out, spec.num_returns)
            except Exception as e:  # noqa: BLE001 - app error
                if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                    try:
                        cw._gcs.call(
                            "report_actor_death",
                            actor_id_hex=spec.actor_id.hex(),
                            reason=f"creation failed: {e}", restart=False)
                    except Exception:  # noqa: BLE001 - NM death report covers it
                        pass
                will_exit = decide_exit()
                self._report_error(
                    spec, exc.RayTaskError(
                        spec.function_name, traceback.format_exc(), e),
                    worker_exiting=will_exit)
                return
            from ray_tpu_torch._private.object_ref import collect_serialized_refs
            all_collected: List[Any] = []
            per_return: List[Optional[List[Tuple]]] = []
            for i, v in enumerate(values):
                oid = ObjectID.for_task_return(spec.task_id, i + 1)
                collected: List[Any] = []
                with collect_serialized_refs(collected):
                    # scatter-write: serialize + store in one copy
                    results.append(cw.store_value(oid.hex(), v))
                # PER RETURN: borrows must key to the return value that
                # actually embeds the ref (freeing return 0 must not
                # release refs held only by return 1)
                per_return.append(
                    [(r.id, tuple(r.owner_address)
                      if r.owner_address else cw.address)
                     for r in collected] or None)
                all_collected.extend(collected)
            nested = None
            pin_handle = None
            if all_collected:
                # ObjectRefs embedded in RESULTS: their descriptors ride
                # the done report so the task's owner registers borrows
                # EAGERLY (released when it frees the enclosing result)
                # — reference ReferenceCounter "contained refs". Transit
                # pins bridge the report: held until the owner ACKS (the
                # report goes blocking when nested refs ride it — see
                # _report_done), since our python refs die right after
                # this frame. Releasing on a wall-clock TTL instead let
                # a chaos-delayed report outlive the pins and observe
                # freed nested objects (ADVICE r5); the TTL survives
                # only as the no-ack fallback below.
                nested = per_return
                pin_handle = cw.pin_refs(all_collected)
            # recycling decision rides the report so the owner retires
            # this worker's lease (reuse=False) atomically — a
            # post-report exit would race new leases onto a dying process
            will_exit = decide_exit()
            ok = self._report_done(spec, results, worker_exiting=will_exit,
                                   nested_refs=nested)
            if pin_handle is not None:
                if ok:
                    cw.release_pins_now(pin_handle)
                else:
                    cw.release_pins_after(pin_handle,
                                          Config.transit_pin_ttl_s)
        finally:
            _spans.finish_span(_task_span)
            cw.task_events.record(spec.task_id.hex(), ts_exec_end=_ev_now())
            cw.set_current_task(None)
            cw.set_current_trace(None)
            if spec.task_type == TaskType.NORMAL_TASK:
                cw.current_placement_group_id = None
            if will_exit:
                logger.info("max_calls=%d reached for %s; worker exiting",
                            spec.max_calls, spec.function_name)
                try:
                    cw.task_events.flush()
                except Exception:  # noqa: BLE001 - exiting either way
                    pass
                os._exit(0)

    def _emit_dynamic_children(self, spec: TaskSpec, iterator: Any,
                               decide_exit) -> None:
        """Drain a generator's items into child objects, reporting each
        incrementally (streaming consumers iterate before the task
        finishes); the declared return resolves to the child-ref list.
        Incremental reports ride a background drainer so a slow owner
        never blocks the producer; the task-end batch is the safety
        net."""
        cw = self.cw
        report_q: "queue.Queue" = queue.Queue()

        def _report_children() -> None:
            owner = cw._pool.get(spec.owner_address)
            while True:
                item = report_q.get()
                if item is None:
                    return
                child, loc = item
                try:
                    owner.send_oneway("cw_dynamic_child",
                                      task_id=spec.task_id,
                                      child=child, loc=loc)
                except Exception:  # noqa: BLE001
                    return  # batch report covers the rest

        reporter = threading.Thread(
            target=_report_children, daemon=True,
            name="dynamic-child-report")
        reporter.start()
        children = []
        for i, item in enumerate(iterator):
            child = ObjectID.for_task_return(spec.task_id, i + 2)
            loc = cw.store_value(child.hex(), item)
            children.append((child, loc))
            report_q.put((child, loc))
        report_q.put(None)
        reporter.join(timeout=30)
        will_exit = decide_exit()
        self._report_done(
            spec,
            [(INLINE,
              ser.pack([ObjectRef(oid, spec.owner_address,
                                  _register=False)
                        for oid, _ in children]))],
            dynamic_children=children,
            worker_exiting=will_exit)

    @staticmethod
    def _split_returns(out: Any, num_returns: int) -> List[Any]:
        if num_returns == 1:
            return [out]
        if num_returns == 0:
            return []
        out_list = list(out)
        if len(out_list) != num_returns:
            raise ValueError(
                f"task declared num_returns={num_returns} but returned "
                f"{len(out_list)} values")
        return out_list

    def _report_done(self, spec: TaskSpec, results: List[Tuple],
                     dynamic_children: Optional[List[Tuple]] = None,
                     worker_exiting: bool = False,
                     nested_refs: Optional[List[Tuple]] = None) -> bool:
        """Report completion to the owner; returns True when the owner
        ACKED the report (blocking path) — the caller may then release
        transit pins immediately instead of waiting out a TTL."""
        lease_id = getattr(spec, "_lease_id", None)
        try:
            return self._report_done_once(spec, results, lease_id,
                                          dynamic_children,
                                          worker_exiting, nested_refs)
        except Exception:  # noqa: BLE001 - transient send failure
            pass
        # A LOST completion report strands the task at its owner forever
        # (the owner keeps waiting, its arg pins never release — the
        # permanent-leak class the ownership fuzzer's drop schedules
        # exercise). cw_task_done is duplicate-safe, so retry the report
        # BLOCKING with backoff; only an owner that stays unreachable
        # loses its results (and they are moot with it).
        for delay_s in (0.1, 0.4, 1.0):
            time.sleep(delay_s)
            try:
                self.cw._pool.get(spec.owner_address).call(
                    "cw_task_done", task_id=spec.task_id,
                    results=results, lease_id=lease_id,
                    dynamic_children=dynamic_children,
                    worker_exiting=worker_exiting,
                    nested_refs=nested_refs)
                return True
            except Exception:  # noqa: BLE001 - retried below
                continue
        logger.warning("owner %s unreachable for task result",
                       spec.owner_address)
        return False

    def _report_done_once(self, spec: TaskSpec, results: List[Tuple],
                          lease_id, dynamic_children,
                          worker_exiting: bool, nested_refs) -> bool:
        if worker_exiting or nested_refs:
            # BLOCKING when this process is about to exit (max_calls
            # recycling: the owner must record the result before the
            # NM's worker-death report can race in, else a task that
            # succeeded gets retried — side effects twice) AND when
            # ObjectRefs ride the result: the owner registers its
            # eager nested borrows inside this call, so on return
            # the transit pins may drop — a one-way report delayed
            # in flight (chaos `delay` on this path) could otherwise
            # arrive after the pins' TTL and find the nested objects
            # freed (ADVICE r5).
            if worker_exiting:
                # earlier one-way reports may still sit on the drainer;
                # ship them before the exit-ack — a report lost with
                # the exiting process would retry an already-succeeded
                # task (side effects twice)
                self._flush_reports()
            self.cw._pool.get(spec.owner_address).call(
                "cw_task_done", task_id=spec.task_id,
                results=results, lease_id=lease_id,
                dynamic_children=dynamic_children,
                worker_exiting=worker_exiting,
                nested_refs=nested_refs)
            return True
        report = dict(task_id=spec.task_id, results=results,
                      lease_id=lease_id,
                      dynamic_children=dynamic_children,
                      worker_exiting=worker_exiting,
                      nested_refs=nested_refs)
        if Config.task_done_batching:
            # hand off to the drainer: delivery failures are retried
            # there (blocking, per report) with the same backoff this
            # method's caller would apply
            self._report_q.put((tuple(spec.owner_address),
                                spec.owner_node_id, report))
            return False
        # one-way: the worker moves on to its next task without
        # waiting out the owner's bookkeeping round trip (send
        # failures still raise; a dead owner is the only loss case
        # and its results are moot)
        if not self.cw._shm_send(tuple(spec.owner_address),
                                 spec.owner_node_id, "cw_task_done",
                                 report):
            self.cw._pool.get(spec.owner_address).send_oneway(
                "cw_task_done", **report)
        return False

    def _report_drain_loop(self) -> None:
        while True:
            first = self._report_q.get()
            self._report_idle.clear()
            batch = [first]
            try:
                while True:
                    batch.append(self._report_q.get_nowait())
            except queue.Empty:
                pass
            self._ship_batch(batch)
            if self._report_q.empty():
                self._report_idle.set()

    def _ship_batch(self, batch: List[Tuple]) -> None:
        by_owner: Dict[Tuple, List[Dict]] = {}
        for owner, owner_node, report in batch:
            by_owner.setdefault((owner, owner_node), []).append(report)
        for (owner, owner_node), reports in by_owner.items():
            self._ship_reports(owner, owner_node, reports)

    def _ship_reports(self, owner, owner_node,
                      reports: List[Dict]) -> None:
        cw = self.cw
        try:
            with _spans.span("cw.task_done_batch", n=len(reports)):
                if len(reports) == 1:
                    if not cw._shm_send(owner, owner_node,
                                        "cw_task_done", reports[0]):
                        cw._pool.get(owner).send_oneway(
                            "cw_task_done", **reports[0])
                elif not cw._shm_send(owner, owner_node,
                                      "cw_task_done_batch",
                                      dict(reports=reports)):
                    cw._pool.get(owner).send_oneway(
                        "cw_task_done_batch", reports=reports)
            return
        except Exception:  # noqa: BLE001 - fall through to per-report
            pass           # blocking retries
        # A LOST completion report strands the task at its owner (see
        # _report_done); each report retries individually so one bad
        # element can't take its batch siblings down with it.
        for r in reports:
            delivered = False
            for delay_s in (0.1, 0.4, 1.0):
                time.sleep(delay_s)
                try:
                    cw._pool.get(owner).call("cw_task_done", **r)
                    delivered = True
                    break
                except Exception:  # noqa: BLE001 - retried with backoff;
                    continue       # the owner may be mid-restart
            if not delivered:
                logger.warning("owner %s unreachable for task result",
                               owner)

    def _flush_reports(self) -> None:
        """Ship everything queued on the done-report drainer from the
        CALLING thread, then wait (bounded) for the drainer to go idle
        so no report is left in its hands when the process exits."""
        while True:
            batch = []
            try:
                while True:
                    batch.append(self._report_q.get_nowait())
            except queue.Empty:
                pass
            if not batch:
                break
            self._ship_batch(batch)
        self._report_idle.wait(timeout=2.0)

    def _report_error(self, spec: TaskSpec, err: Exception,
                      worker_exiting: bool = False) -> None:
        try:
            self._emit_error_postmortem(spec, err)
        except Exception:  # noqa: BLE001 - diagnostics never block reports
            pass
        blob = pickle.dumps(err)
        self._report_done(spec, [(ERROR, blob)] * max(spec.num_returns, 1)
                          if spec.num_returns else [],
                          worker_exiting=worker_exiting)

    def _emit_error_postmortem(self, spec: TaskSpec,
                               err: Exception) -> None:
        """Task-failure bundle (the worker survives, so it captures its
        own context): traceback + recent log records + span-ring tail,
        one-way into the GCS's bounded postmortem ring — queryable via
        util.state.postmortems() / `ray_tpu logs --postmortem`."""
        cw = self.cw
        k = int(Config.postmortem_span_tail)
        bundle = {
            "kind": "task_error",
            "task_id": spec.task_id.hex(),
            "task": spec.function_name,
            "worker_id": cw.worker_id.hex(),
            "node_id": cw.node_id_hex,
            "actor_id": self.actor_id.hex() if self.actor_id else None,
            "trace_id": spec.trace_id,
            "reason": repr(err),
            "traceback": getattr(err, "traceback_str", "") or "",
            "ts": time.time(),
            "log_tail": _log_plane.tail(int(Config.postmortem_log_lines)),
            "span_tail": [list(r) for r in
                          _spans.ring().snapshot_records()[-k:]],
            "gauges": {"rss_bytes": _log_plane.read_rss_bytes()},
        }
        cw._pool.get(cw.gcs_address).send_oneway(
            "postmortem_report", bundle=bundle)
