"""Autoscaler v2: instance-manager architecture.

reference parity: python/ray/autoscaler/v2/ — the v2 rewrite separates
(a) a CLUSTER STATUS view served by the GCS
(GcsAutoscalerStateManager, autoscaler.proto: pending resource
requests + node states), (b) a pure SCHEDULER deciding desired
instances from that status (v2/scheduler.py), and (c) an INSTANCE
MANAGER owning each instance's lifecycle state machine
(v2/instance_manager/: QUEUED -> REQUESTED -> ALLOCATED ->
RAY_RUNNING -> TERMINATING -> TERMINATED) against a cloud provider.
v1 conflates all three in StandardAutoscaler; v2's split makes each
piece testable alone — the same property here: ClusterStatusReader is
the GCS-facing piece, InstanceManager drives the provider, and
AutoscalerV2.run_once wires them through the shared demand scheduler
(demand_scheduler.get_nodes_to_launch).

The lifecycle is an explicit state machine (reference
v2/instance_manager/common.py InstanceUtil.get_valid_transitions):
illegal edges raise InstanceLifecycleError at the source, provider
errors are retried on a bounded budget, instances wedged in a
non-terminal state past a per-state timeout are swept (terminated or
re-queued), and every transition is published as a lifecycle event —
both to in-process listeners and, when a GCS address is configured,
onto the "autoscaler_lifecycle" pubsub channel + the cluster event log
so elastic trainers (train/backend_executor.py) can subscribe to
membership changes.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import NodeProvider
from ray_tpu_torch.autoscaler.demand_scheduler import (NodeType,
                                                 PlacementGroupDemand,
                                                 get_nodes_to_launch)

logger = logging.getLogger(__name__)

# instance lifecycle (reference v2/instance_manager/common.py states)
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"

# the legal edge set (reference InstanceUtil.get_valid_transitions):
# REQUESTED->QUEUED is the bounded provider-error retry; *->TERMINATED
# shortcuts exist only where the instance has nothing to release
# (QUEUED never touched the provider; a vanished provider node has
# nothing left to terminate).
LEGAL_TRANSITIONS: Dict[str, frozenset] = {
    QUEUED: frozenset({REQUESTED, TERMINATED}),
    REQUESTED: frozenset({ALLOCATED, QUEUED, TERMINATED}),
    ALLOCATED: frozenset({RAY_RUNNING, TERMINATING, TERMINATED}),
    RAY_RUNNING: frozenset({TERMINATING, TERMINATED}),
    TERMINATING: frozenset({TERMINATED}),
    TERMINATED: frozenset(),
}

# how long an instance may sit in a state before the reconciler calls
# it stuck (reference reconciler stuck-instance handling): REQUESTED
# covers a wedged provider call, ALLOCATED a node that never joined
# the GCS, TERMINATING a wedged teardown. 0/None disables a state's
# sweep. QUEUED has no timeout: queued instances are retried by
# drive() on its own budget.
DEFAULT_STUCK_TIMEOUTS: Dict[str, float] = {
    REQUESTED: 120.0,
    ALLOCATED: 300.0,
    TERMINATING: 60.0,
}


class InstanceLifecycleError(RuntimeError):
    """An illegal lifecycle edge was requested (bug at the call site)."""


@dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = QUEUED
    provider_node: Any = None
    node_id_hex: Optional[str] = None
    launched_at: float = field(default_factory=time.time)
    # previous statuses, oldest first (plain strings; the full records
    # live in `transitions`)
    status_history: List[str] = field(default_factory=list)
    transitions: List[Dict[str, Any]] = field(default_factory=list)
    retries: int = 0
    state_since: float = field(default_factory=time.monotonic)

    def set_status(self, status: str, reason: str = "") -> Dict[str, Any]:
        if status not in LEGAL_TRANSITIONS:
            raise InstanceLifecycleError(
                f"unknown instance status {status!r}")
        if status not in LEGAL_TRANSITIONS[self.status]:
            raise InstanceLifecycleError(
                f"illegal lifecycle edge {self.status} -> {status} for "
                f"instance {self.instance_id} ({self.node_type})")
        record = {
            "instance_id": self.instance_id,
            "node_type": self.node_type,
            "from": self.status,
            "to": status,
            "reason": reason,
            "node_id_hex": self.node_id_hex,
            "ts": time.time(),
        }
        self.status_history.append(self.status)
        self.transitions.append(record)
        self.status = status
        self.state_since = time.monotonic()
        return record

    def age_in_state(self) -> float:
        return time.monotonic() - self.state_since

    def to_dict(self) -> Dict[str, Any]:
        return {
            "instance_id": self.instance_id,
            "node_type": self.node_type,
            "status": self.status,
            "node_id_hex": self.node_id_hex,
            "launched_at": self.launched_at,
            "retries": self.retries,
            "age_in_state_s": round(self.age_in_state(), 3),
            "status_history": list(self.status_history),
        }


@dataclass
class ClusterStatus:
    """The GcsAutoscalerStateManager view (autoscaler.proto
    GetClusterResourceState): what the scheduler needs, nothing else."""

    pending_demands: List[Dict[str, float]] = field(default_factory=list)
    node_available: List[Dict[str, float]] = field(default_factory=list)
    alive_node_ids: List[str] = field(default_factory=list)
    busy_node_ids: List[str] = field(default_factory=list)


class ClusterStatusReader:
    """Builds ClusterStatus from the GCS + node managers (the
    in-process equivalent of the GCS autoscaler state RPC). Pending
    demand covers BOTH queued worker leases (per-NM
    pending_resource_shapes) and PENDING placement groups (the gang
    demand an elastic trainer's unscheduled replacement-probe bundles
    produce — reference: the v2 cluster resource state carries
    gang_resource_requests)."""

    def __init__(self, gcs_address: str, *,
                 nm_unreachable_rounds: int = 3):
        from ray_tpu_torch._private import rpc as rpc_lib
        host, port = gcs_address.rsplit(":", 1)
        self._gcs = rpc_lib.RpcClient((host, int(port)), timeout=60)
        self._pool = rpc_lib.ClientPool(timeout=30)
        # consecutive failed NM polls before a GCS-alive node reads as
        # cluster-dead: ONE transient RPC timeout must not feed the
        # zombie sweep (it would terminate a healthy host and its
        # gang), but a sustained partition still must — the GCS's own
        # health probes may not share the reader's network vantage
        self.nm_unreachable_rounds = nm_unreachable_rounds
        self._nm_fail_rounds: Dict[str, int] = {}

    def read(self) -> ClusterStatus:
        status = ClusterStatus()
        try:
            nodes = [n for n in self._gcs.call("get_all_nodes")
                     if n.alive]
        except Exception:  # noqa: BLE001
            return status
        # fail streaks are only meaningful for nodes the GCS currently
        # lists: a node that left and re-registered (blip) must start a
        # fresh streak, and counters for long-gone nodes must not
        # accumulate into a later same-id node's verdict (or leak)
        seen = {n.node_id.hex() for n in nodes}
        for stale in [nid for nid in self._nm_fail_rounds
                      if nid not in seen]:
            del self._nm_fail_rounds[stale]
        for n in nodes:
            nid = n.node_id.hex()
            try:
                info = self._pool.get(tuple(n.address)).call(
                    "nm_get_info")
                workers = self._pool.get(tuple(n.address)).call(
                    "nm_list_workers")
            except Exception:  # noqa: BLE001 - NM unreachable
                fails = self._nm_fail_rounds.get(nid, 0) + 1
                self._nm_fail_rounds[nid] = fails
                if fails < self.nm_unreachable_rounds:
                    # transient: still alive, contribute no demand or
                    # availability, and count the node busy — idle
                    # scale-down must not reap a node it could not
                    # actually observe idle
                    status.alive_node_ids.append(nid)
                    status.busy_node_ids.append(nid)
                # else: sustained unreachability — omit from the alive
                # set so reconcile() can reclaim the zombie
                continue
            self._nm_fail_rounds.pop(nid, None)
            status.alive_node_ids.append(nid)
            status.pending_demands.extend(
                info.get("pending_resource_shapes") or [])
            status.node_available.append(
                dict(info.get("available") or {}))
            if any(not w["idle"] for w in workers):
                status.busy_node_ids.append(nid)
        try:
            groups = self._gcs.call("list_placement_groups")
        except Exception:  # noqa: BLE001 - older GCS; PG demand unavailable
            groups = []
        for info in groups:
            if getattr(info, "state", None) != "PENDING":
                continue
            demand = PlacementGroupDemand(
                bundles=[dict(b) for b in info.bundles],
                strategy=getattr(info, "strategy", "PACK"))
            status.pending_demands.extend(demand.expand())
        return status


class InstanceManager:
    """Owns instance records and drives them through the lifecycle
    against the provider (reference v2/instance_manager): QUEUED
    instances are pumped through the provider by drive() on a bounded
    retry budget, reconcile() advances/retires instances from the
    cluster's point of view and sweeps stuck states, and every
    transition is fanned out to lifecycle listeners."""

    def __init__(self, provider: NodeProvider, *,
                 max_launch_retries: int = 2,
                 stuck_timeouts: Optional[Dict[str, float]] = None,
                 on_event: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.provider = provider
        self.instances: Dict[str, Instance] = {}
        self.max_launch_retries = max_launch_retries
        self.stuck_timeouts = dict(DEFAULT_STUCK_TIMEOUTS)
        if stuck_timeouts:
            self.stuck_timeouts.update(stuck_timeouts)
        self._listeners: List[Callable[[Dict[str, Any]], None]] = []
        if on_event is not None:
            self._listeners.append(on_event)

    # ---- events -----------------------------------------------------
    def add_listener(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        self._listeners.append(fn)

    def _transition(self, inst: Instance, status: str,
                    reason: str = "") -> None:
        record = inst.set_status(status, reason)
        for fn in list(self._listeners):
            try:
                fn(record)
            except Exception:  # noqa: BLE001 - a broken listener must not
                logger.exception("lifecycle listener failed")  # stall scaling

    # ---- launch path ------------------------------------------------
    def request(self, node_type: NodeType) -> Instance:
        """Enqueue a launch (QUEUED); drive()/launch() pump it through
        the provider."""
        inst = Instance(instance_id=uuid.uuid4().hex[:12],
                        node_type=node_type.name)
        self.instances[inst.instance_id] = inst
        return inst

    def launch(self, node_type: NodeType) -> Instance:
        """request + one synchronous drive attempt (the v1-compatible
        entry point; failures stay QUEUED for later drive() retries
        while budget remains)."""
        inst = self.request(node_type)
        self._drive_instance(inst, node_type)
        return inst

    def _drive_instance(self, inst: Instance,
                        node_type: NodeType) -> None:
        self._transition(inst, REQUESTED, "launch requested")
        try:
            node = self.provider.create_node(dict(node_type.resources))
        except Exception as e:  # noqa: BLE001
            inst.retries += 1
            if inst.retries > self.max_launch_retries:
                logger.exception(
                    "provider launch failed for %s; retry budget "
                    "(%d) exhausted", node_type.name,
                    self.max_launch_retries)
                self._transition(
                    inst, TERMINATED,
                    f"provider error after {inst.retries} attempts: "
                    f"{e!r}")
            else:
                logger.warning(
                    "provider launch failed for %s (attempt %d/%d): "
                    "%r; re-queued", node_type.name, inst.retries,
                    self.max_launch_retries + 1, e)
                self._transition(
                    inst, QUEUED,
                    f"provider error (attempt {inst.retries}): {e!r}")
            return
        inst.provider_node = node
        inst.node_id_hex = node.node_id_hex
        self._transition(inst, ALLOCATED, "provider node created")

    def drive(self, node_types: Dict[str, NodeType]) -> None:
        """Pump QUEUED instances (provider-error retries) whose type is
        still known."""
        for inst in list(self.instances.values()):
            if inst.status != QUEUED:
                continue
            node_type = node_types.get(inst.node_type)
            if node_type is None:
                self._transition(inst, TERMINATED,
                                 "node type no longer configured")
                continue
            self._drive_instance(inst, node_type)

    # ---- teardown path ----------------------------------------------
    def terminate(self, inst: Instance, reason: str = "") -> None:
        if inst.status in (TERMINATING, TERMINATED):
            return
        if inst.status in (QUEUED, REQUESTED):
            # never touched / never got a provider node: nothing to
            # release
            self._transition(inst, TERMINATED,
                             reason or "terminated before allocation")
            return
        self._transition(inst, TERMINATING, reason)
        try:
            if inst.provider_node is not None:
                self.provider.terminate_node(inst.provider_node)
        except Exception:  # noqa: BLE001
            logger.exception("provider terminate failed for %s",
                             inst.instance_id)
            # stay TERMINATING: transitioning to TERMINATED would
            # record a clean release for a node the provider still
            # runs (and bills). reconcile() retries the release each
            # pass while the provider lists the node; the TERMINATING
            # stuck-sweep is the forced backstop.
            return
        self._transition(inst, TERMINATED, reason)

    # ---- reconcile --------------------------------------------------
    def reconcile(self, alive_node_ids: List[str]) -> None:
        """Advance ALLOCATED instances whose node joined the cluster to
        RAY_RUNNING; mark instances whose provider node vanished
        TERMINATED; sweep instances stuck in a non-terminal state past
        their per-state timeout (reference: instance reconciler)."""
        live = {n.provider_id for n in
                self.provider.non_terminated_nodes()}
        for inst in list(self.instances.values()):
            if inst.status == ALLOCATED and \
                    inst.node_id_hex in alive_node_ids:
                self._transition(inst, RAY_RUNNING,
                                 "node joined the cluster")
            elif inst.status in (ALLOCATED, RAY_RUNNING, TERMINATING) \
                    and inst.provider_node is not None and \
                    inst.provider_node.provider_id not in live:
                self._transition(inst, TERMINATED,
                                 "provider node vanished")
            elif inst.status == TERMINATING and \
                    inst.provider_node is not None and \
                    inst.provider_node.provider_id in live:
                # a terminate whose provider call failed: retry the
                # release each pass until the node actually leaves
                try:
                    self.provider.terminate_node(inst.provider_node)
                except Exception:  # noqa: BLE001 - provider still
                    logger.warning(   # failing; next pass retries
                        "provider terminate retry failed for %s",
                        inst.instance_id)
                else:
                    self._transition(inst, TERMINATED,
                                     "released on retry")
            elif inst.status == RAY_RUNNING and alive_node_ids and \
                    inst.node_id_hex not in alive_node_ids:
                # the cluster declared the node dead (health checks)
                # while the provider still lists it — a zombie host
                # (partitioned / preempted mid-teardown): release it so
                # its capacity can be replaced. Guarded on a non-empty
                # alive set: a failed status read must not mass-
                # terminate the fleet.
                self.terminate(inst, "cluster reports node dead")
        self._sweep_stuck()
        self._prune_terminated()

    def _sweep_stuck(self) -> None:
        for inst in list(self.instances.values()):
            timeout = self.stuck_timeouts.get(inst.status)
            if not timeout or inst.age_in_state() < timeout:
                continue
            reason = (f"stuck in {inst.status} for "
                      f"{inst.age_in_state():.0f}s (> {timeout:.0f}s)")
            if inst.status == TERMINATING:
                # teardown wedged: the provider call already ran (or
                # raised); stop waiting on it
                self._transition(inst, TERMINATED, reason)
            elif inst.status == ALLOCATED and \
                    inst.retries < self.max_launch_retries:
                # node never joined the GCS: release it and re-queue a
                # replacement carrying the retry budget forward
                self.terminate(inst, reason)
                replacement = Instance(
                    instance_id=uuid.uuid4().hex[:12],
                    node_type=inst.node_type,
                    retries=inst.retries + 1)
                self.instances[replacement.instance_id] = replacement
            else:
                self.terminate(inst, reason)

    # retain only this many TERMINATED records: the table would
    # otherwise grow one permanent entry (with full transition history,
    # re-pickled to the GCS every poll pass) per preemption/idle flap
    # for the life of the autoscaler
    MAX_TERMINATED_KEPT = 64

    def _prune_terminated(self) -> None:
        dead = [i for i in self.instances.values()
                if i.status == TERMINATED]
        if len(dead) <= self.MAX_TERMINATED_KEPT:
            return
        dead.sort(key=lambda i: i.state_since)
        for inst in dead[:-self.MAX_TERMINATED_KEPT]:
            del self.instances[inst.instance_id]

    # ---- views ------------------------------------------------------
    def active(self) -> List[Instance]:
        return [i for i in self.instances.values()
                if i.status in (QUEUED, REQUESTED, ALLOCATED,
                                RAY_RUNNING)]

    def snapshot(self) -> List[Dict[str, Any]]:
        return [i.to_dict() for i in self.instances.values()]


class AutoscalerV2:
    """run_once: read status -> reconcile/drive the instance manager ->
    schedule -> launch/terminate (reference v2 autoscaler loop).
    start()/stop() run the loop on a thread. With `gcs_address` set,
    lifecycle transitions and the instance table are reported to the
    GCS (`autoscaler_v2_report`): events land in the cluster event log
    and on the "autoscaler_lifecycle" pubsub channel, the table behind
    `ray_tpu autoscaler` / util.state.autoscaler_instances() /
    /api/autoscaler."""

    def __init__(self, status_reader: Any, provider: NodeProvider,
                 node_types: List[NodeType], *,
                 max_nodes: int = 8, idle_timeout_s: float = 30.0,
                 gcs_address: Optional[str] = None,
                 max_launch_retries: int = 2,
                 stuck_timeouts: Optional[Dict[str, float]] = None,
                 poll_period_s: float = 2.0):
        self.reader = status_reader
        self.im = InstanceManager(
            provider, max_launch_retries=max_launch_retries,
            stuck_timeouts=stuck_timeouts,
            on_event=self._on_lifecycle_event)
        self.node_types = {t.name: t for t in node_types}
        self.max_nodes = max_nodes
        self.idle_timeout_s = idle_timeout_s
        self.poll_period_s = poll_period_s
        self._idle_since: Dict[str, float] = {}
        self._pending_events: List[Dict[str, Any]] = []
        self._events_lock = threading.Lock()
        self._gcs = None
        if gcs_address:
            from ray_tpu_torch._private import rpc as rpc_lib
            host, port = gcs_address.rsplit(":", 1)
            self._gcs = rpc_lib.RpcClient((host, int(port)), timeout=30)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle-event fan-out ------------------------------------
    def _on_lifecycle_event(self, record: Dict[str, Any]) -> None:
        with self._events_lock:
            self._pending_events.append(record)

    def _report(self) -> None:
        """Ship buffered lifecycle events + the instance table to the
        GCS in one RPC per pass (batched: a scale-up of N nodes is one
        report, not N)."""
        if self._gcs is None:
            with self._events_lock:
                self._pending_events.clear()
            return
        with self._events_lock:
            events, self._pending_events = self._pending_events, []
        try:
            self._gcs.call("autoscaler_v2_report",
                           instances=self.im.snapshot(), events=events)
        except Exception:  # noqa: BLE001 - reporting is best-effort;
            # the next pass re-ships the full instance table — but the
            # EVENTS are deltas (event log, lifecycle pubsub a trainer
            # may be waiting on), so put them back for the next pass,
            # drop-oldest bounded in case the GCS stays down
            logger.warning("autoscaler v2: state report failed",
                           exc_info=True)
            with self._events_lock:
                self._pending_events[:0] = events
                del self._pending_events[:-512]

    # ---- loop -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler-v2")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_period_s):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001
                logger.exception("autoscaler v2 iteration failed")

    def run_once(self) -> None:
        status: ClusterStatus = self.reader.read()
        self.im.reconcile(status.alive_node_ids)
        self.im.drive(self.node_types)  # provider-error retries
        active = self.im.active()
        launched = 0
        unplaceable: List[Dict[str, float]] = []
        if status.pending_demands and len(active) < self.max_nodes:
            # count BOOTING instances (QUEUED/REQUESTED/ALLOCATED —
            # launched but not yet alive in the GCS) as existing
            # capacity, or a single pending demand re-launches a node
            # on every tick for the minutes a real node takes to boot
            booting = [dict(self.node_types[i.node_type].resources)
                       for i in active
                       if i.status in (QUEUED, REQUESTED, ALLOCATED)
                       and i.node_type in self.node_types]
            to_launch, unplaceable = get_nodes_to_launch(
                status.pending_demands,
                list(status.node_available) + booting,
                list(self.node_types.values()),
                max_total_nodes=self.max_nodes + 1)
            for type_name, count in to_launch.items():
                for _ in range(count):
                    if len(self.im.active()) >= self.max_nodes:
                        break
                    self.im.launch(self.node_types[type_name])
                    launched += 1
            if unplaceable:
                logger.warning("autoscaler v2: %d unplaceable demands",
                               len(unplaceable))
        if launched:
            self._report()
            return
        # idle scale-down: runs unless there is PLACEABLE demand
        # pressure — a permanently unplaceable demand must not pin idle
        # nodes forever. Guarded on a non-empty alive set like the
        # zombie sweep: a failed status read (GCS outage) yields an
        # EMPTY ClusterStatus whose busy/demand silence would read as
        # "everything idle" and terminate the whole fleet.
        if not status.alive_node_ids:
            self._report()
            return
        placeable_pending = (len(status.pending_demands)
                             - len(unplaceable)) if unplaceable else \
            len(status.pending_demands)
        now = time.monotonic()
        for inst in self.im.active():
            if inst.status != RAY_RUNNING:
                continue
            busy = inst.node_id_hex in status.busy_node_ids
            if not busy and placeable_pending == 0:
                first = self._idle_since.setdefault(inst.instance_id,
                                                    now)
                if now - first >= self.idle_timeout_s:
                    self.im.terminate(
                        inst, f"idle for {self.idle_timeout_s:.0f}s")
                    self._idle_since.pop(inst.instance_id, None)
            else:
                self._idle_since.pop(inst.instance_id, None)
        self._report()
