"""Global Control Store: cluster control plane.

reference parity: src/ray/gcs/gcs_server/ — GcsServer (gcs_server.h:78) with
node membership (GcsNodeManager), actor directory + scheduling
(GcsActorManager/GcsActorScheduler), internal KV (GcsInternalKVManager),
function table (GcsFunctionManager), pub/sub (GcsPublisher), health checks
(GcsHealthCheckManager) and job accounting (GcsJobManager). Storage is an
in-process dict behind a small StoreClient-like interface so a persistent
backend can be swapped in (reference gcs_table_storage.h).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import rpc as rpc_lib
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, WorkerID
from ray_tpu_torch._private.state import (ActorInfo, NodeInfo, PlacementGroupInfo,
                                    ResourceSet, TaskSpec)
from ray_tpu_torch.util.locks import TracedLock

logger = logging.getLogger(__name__)


class InMemoryStore:
    """Pluggable table storage (reference in_memory_store_client.h)."""

    def __init__(self) -> None:
        self._tables: Dict[str, Dict[str, Any]] = {}
        self._lock = TracedLock("gcs_store")

    def put(self, table: str, key: str, value: Any) -> None:
        with self._lock:
            self._tables.setdefault(table, {})[key] = value
            self._on_mutate_locked()

    def get(self, table: str, key: str) -> Any:
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def delete(self, table: str, key: str) -> bool:
        with self._lock:
            hit = self._tables.get(table, {}).pop(key, None) is not None
            if hit:
                self._on_mutate_locked()
            return hit

    def keys(self, table: str, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._tables.get(table, {}) if k.startswith(prefix)]

    def items(self, table: str) -> List[Tuple[str, Any]]:
        with self._lock:
            return list(self._tables.get(table, {}).items())

    def _on_mutate_locked(self) -> None:
        pass


class PersistentStore(InMemoryStore):
    """File-backed table storage (reference redis_store_client.h role:
    GCS state survives a control-plane restart — gcs_table_storage.h:242,
    reloaded like GcsInitData on boot). Snapshots the tables atomically
    on mutation, debounced to one write per DEBOUNCE_S."""

    DEBOUNCE_S = 0.2

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self._dirty = False
        self._flush_lock = TracedLock("gcs_flush")
        if os.path.exists(path):
            import pickle as _pickle
            try:
                with open(path, "rb") as f:
                    self._tables = _pickle.load(f)
            except Exception:  # noqa: BLE001 - corrupt snapshot must not
                # brick the control plane; set it aside and start fresh
                corrupt = f"{path}.corrupt"
                logger.error("GCS snapshot %s unreadable; moving to %s "
                             "and starting empty", path, corrupt)
                try:
                    os.replace(path, corrupt)
                except OSError:
                    pass
        self._flusher = threading.Thread(target=self._flush_loop,
                                         daemon=True, name="gcs-persist")
        self._stopped = False
        self._flusher.start()

    def _on_mutate_locked(self) -> None:
        self._dirty = True

    def flush(self) -> None:
        import pickle as _pickle
        # _flush_lock serializes writers (flusher thread vs stop()): both
        # use the same tmp path, and interleaved writes would install a
        # corrupt snapshot.
        with self._flush_lock:
            with self._lock:
                if not self._dirty:
                    return
                blob = _pickle.dumps(self._tables)
                self._dirty = False
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, self.path)

    def _flush_loop(self) -> None:
        while not self._stopped:
            time.sleep(self.DEBOUNCE_S)
            try:
                self.flush()
            except Exception:  # noqa: BLE001
                logger.exception("GCS persistence flush failed")

    def stop(self) -> None:
        self._stopped = True
        self.flush()


class GcsServer:
    """The control-plane process (can be hosted in a thread or standalone)."""

    # Class-level defaults; __init__ reads the live values from Config so
    # operators can tune them per-cluster (reference
    # gcs_health_check_manager.h: health_check_period_ms +
    # health_check_failure_threshold). K consecutive probe failures are
    # required before a node is declared dead — a single chaos-delayed or
    # GC-paused probe must not kill a healthy node.
    HEALTH_CHECK_PERIOD_S = 2.0
    HEALTH_CHECK_FAILURES_TO_DEAD = 3

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None):
        from ray_tpu_torch._private.config import Config
        self.HEALTH_CHECK_PERIOD_S = Config.health_check_period_s
        self.HEALTH_CHECK_FAILURES_TO_DEAD = max(
            1, Config.health_check_failure_threshold)
        # Pluggable storage (reference StoreClient): file-backed when a
        # persist path is given (env RAY_TPU_GCS_PERSIST_PATH works too),
        # so KV state — function table, job metadata, checkpoint pointers
        # — survives a GCS restart.
        persist_path = persist_path or os.environ.get(
            "RAY_TPU_GCS_PERSIST_PATH")
        self._persist_path = persist_path
        self.store = PersistentStore(persist_path) if persist_path \
            else InMemoryStore()
        self._pool = rpc_lib.ClientPool(timeout=30)
        self._lock = TracedLock("gcs")
        # node_id hex -> NodeInfo
        self.nodes: Dict[str, NodeInfo] = {}
        # node_id hex -> {resource: available} (synced by node managers)
        self.node_available: Dict[str, Dict[str, float]] = {}
        # last accepted resource-report version per node (syncer-style
        # out-of-order protection)
        self.node_resource_version: Dict[str, int] = {}
        self.node_health_failures: Dict[str, int] = {}
        # actor_id hex -> ActorInfo ; actor specs kept for restart
        self.actors: Dict[str, ActorInfo] = {}
        self.actor_specs: Dict[str, TaskSpec] = {}
        self.named_actors: Dict[Tuple[str, str], str] = {}  # (ns, name)->id hex
        # channel -> [(subscriber rpc address, token)]
        self.subscribers: Dict[str, List[Tuple[Tuple[str, int], str]]] = {}
        self.job_counter = 0
        # pg_id hex -> PlacementGroupInfo
        self.placement_groups: Dict[str, "PlacementGroupInfo"] = {}
        # Task event sink (reference GcsTaskManager, gcs_task_manager.h:85):
        # merged task records keyed by task id, FIFO-capped.
        self.task_events: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.task_events_dropped = 0
        # Structured cluster events (reference util/event.h → the
        # dashboard event module): bounded ring of lifecycle records.
        self.cluster_events: List[Dict[str, Any]] = []
        self.CLUSTER_EVENTS_MAX = 4096
        # autoscaler v2 lifecycle plane: latest instance table + a
        # bounded ring of lifecycle transitions (autoscaler/v2.py
        # reports both each pass)
        self.autoscaler_instances: List[Dict[str, Any]] = []
        self.autoscaler_events: List[Dict[str, Any]] = []
        self.AUTOSCALER_EVENTS_MAX = 1024
        # Actor waits-for graph (blocking gets between actors) with
        # cycle-at-insert deadlock detection; see _private/wait_graph.py.
        from ray_tpu_torch._private.wait_graph import WaitGraph
        self.wait_graph = WaitGraph()
        # Crash postmortems (debug plane): bounded ring of black-box
        # bundles keyed by postmortem id (node managers report worker
        # deaths, executors report task failures; see
        # node_manager._capture_postmortem / log_plane.py).
        self.postmortems: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        from ray_tpu_torch._private.config import Config as _Config
        self.POSTMORTEMS_MAX = max(1, _Config.postmortems_max)
        # Chaos plane (see _private/chaos.py): ordered rule list + the
        # cluster-wide fired-count aggregate, distributed over pubsub.
        self.chaos_rules: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.chaos_fired: Dict[str, int] = {}
        self.chaos_version = 0
        self._chaos_rule_counter = 0
        # Gang heartbeat table (train/heartbeat.py): gang -> rank ->
        # last beat, stamped with GCS-side monotonic receipt time so
        # age needs no cross-host clock agreement. FIFO-capped on gangs;
        # supervisors clear their gang on teardown.
        self.gang_heartbeats_tbl: "OrderedDict[str, Dict[int, Dict[str, Any]]]" = \
            OrderedDict()
        self.GANG_HEARTBEAT_GANGS_MAX = 64
        self._dead = False

        # Reload the persisted actor directory (reference GcsInitData:
        # on restart the GCS rebuilds state from storage; nodes instead
        # RE-REGISTER via the resource-report loop — see
        # report_resources returning "unknown_node").
        for key in self.store.keys("actors", ""):
            rec = self.store.get("actors", key)
            if rec:
                info, spec = rec
                if info.state in ("PENDING", "RESTARTING"):
                    # its scheduling thread died with the old process
                    info.state = "DEAD"
                    info.death_cause = "GCS restarted mid-scheduling"
                self.actors[key] = info
                if spec is not None:
                    self.actor_specs[key] = spec
        # drop names whose actor record never made it to the snapshot
        # (crash between the two writes) — a name pointing at a missing
        # record would brick every lookup of that name
        self.named_actors.update(
            {k: v for k, v in
             (self.store.get("meta", "named_actors") or {}).items()
             if v in self.actors})

        self.server = rpc_lib.RpcServer({
            # KV (reference InternalKVGcsService)
            "kv_put": self.kv_put,
            "kv_get": self.kv_get,
            "kv_del": self.kv_del,
            "kv_keys": self.kv_keys,
            "kv_exists": self.kv_exists,
            # nodes (reference NodeInfoGcsService / NodeResourceInfoGcsService)
            "register_node": self.register_node,
            "unregister_node": self.unregister_node,
            "get_all_nodes": self.get_all_nodes,
            "report_resources": self.report_resources,
            "get_cluster_resources": self.get_cluster_resources,
            # jobs
            "next_job_id": self.next_job_id,
            # actors (reference ActorInfoGcsService)
            "register_actor": self.register_actor,
            "get_actor_info": self.get_actor_info,
            "get_named_actor": self.get_named_actor,
            "list_named_actors": self.list_named_actors,
            "report_actor_alive": self.report_actor_alive,
            "report_actor_death": self.report_actor_death,
            "kill_actor": self.kill_actor,
            "list_actors": self.list_actors,
            # placement groups (reference PlacementGroupInfoGcsService)
            "create_placement_group": self.create_placement_group,
            "remove_placement_group": self.remove_placement_group,
            "get_placement_group": self.get_placement_group,
            "list_placement_groups": self.list_placement_groups,
            # task events (reference TaskInfoGcsService / GcsTaskManager)
            "add_task_events": self.add_task_events,
            "list_tasks": self.list_tasks,
            # flight recorder: cluster-wide span-ring gather
            # (`ray_tpu timeline --spans`, dashboard /api/timeline?spans=1)
            "spans_collect": self.spans_collect,
            # profiling plane: cluster flamegraph collect (`ray_tpu
            # profile`, dashboard /api/profile; _private/profiler.py)
            "profile_collect": self.profile_collect,
            # memory attribution plane: cluster object table (`ray_tpu
            # memory`, dashboard /api/memory; _private/memory_plane.py)
            "memory_collect": self.memory_collect,
            # lockdep plane: traced-lock snapshots + order graphs
            # (`ray_tpu locks`, dashboard /api/locks; util/locks.py)
            "locks_collect": self.locks_collect,
            # ownership protocol plane: RefState/LeaseState + transition
            # rings (`ray_tpu ownership`, dashboard /api/ownership;
            # _private/ownership.py)
            "ownership_collect": self.ownership_collect,
            # debug plane: attributed-log fan-out + crash postmortems
            # (`ray_tpu logs`, dashboard /api/logs + /api/postmortems)
            "logs_query": self.logs_query,
            "postmortem_report": self.postmortem_report,
            "postmortem_list": self.postmortem_list,
            "postmortem_get": self.postmortem_get,
            # structured events (reference ReportEventService)
            "add_events": self.add_events,
            "list_events": self.list_events,
            # autoscaler v2 (autoscaler/v2.py): lifecycle-event +
            # instance-table report, served back to `ray_tpu
            # autoscaler` / util.state.autoscaler_instances() /
            # /api/autoscaler; each event also lands in the cluster
            # event log and on the "autoscaler_lifecycle" pubsub
            # channel (elastic trainers subscribe for membership
            # changes)
            "autoscaler_v2_report": self.autoscaler_v2_report,
            "autoscaler_v2_state": self.autoscaler_v2_state,
            # actor waits-for graph (deadlock detection)
            "wait_graph_add": self.wait_graph_add,
            "wait_graph_remove": self.wait_graph_remove,
            "wait_graph_snapshot": self.wait_graph_snapshot,
            # gang heartbeat plane (train/heartbeat.py): rank sidecars
            # beat in (oneway), gang supervisors poll ages + the
            # runtime step-deadline override, and clear on teardown
            "gang_heartbeat": self.gang_heartbeat,
            "gang_heartbeats": self.gang_heartbeats,
            "gang_heartbeat_clear": self.gang_heartbeat_clear,
            # chaos plane (_private/chaos.py)
            "chaos_inject": self.chaos_inject,
            "chaos_clear": self.chaos_clear,
            "chaos_list": self.chaos_list,
            "chaos_get_policy": self.chaos_get_policy,
            "chaos_report_fired": self.chaos_report_fired,
            # pubsub (reference InternalPubSubGcsService)
            "subscribe": self.subscribe,
            "unsubscribe": self.unsubscribe,
            "publish": self.publish,
            "ping": lambda: "pong",
        }, host=host, port=port)
        self.address = self.server.address
        # standalone GCS processes get a trace row; in-process head nodes
        # are relabeled by the driver's CoreWorker (one process, one row)
        from ray_tpu_torch._private import spans as spans_lib
        spans_lib.set_process_label("gcs")
        # Cluster metrics plane (_private/metrics_plane.py): harvest
        # sampler + history ring + invariant watchdog, with its RPC
        # surface registered post-construction (the plane needs the live
        # node/subscriber tables this object owns).
        from ray_tpu_torch._private import metrics_plane as metrics_plane_lib
        metrics_plane_lib.register_sampler("gcs",
                                           self._sample_metric_gauges)
        # Durable history segments live next to the KV snapshot when
        # the GCS persists (a restart replays both); explicit
        # Config.metrics_history_dir overrides inside the plane.
        hist_dir = None
        if self._persist_path:
            hist_dir = self._persist_path + ".metrics"
        self.metrics_plane = metrics_plane_lib.MetricsPlane(
            self, history_dir=hist_dir)
        self.server.register("metrics_collect", self.metrics_plane.collect)
        self.server.register("metrics_prometheus",
                             self.metrics_plane.prometheus)
        self.server.register("metrics_merged", self.metrics_plane.merged)
        self.server.register("metrics_history",
                             self.metrics_plane.query_history)
        self.server.register("metrics_history_range",
                             self.metrics_plane.query_history_range)
        self.server.register("metrics_configure",
                             self.metrics_plane.configure)
        self._health_thread = threading.Thread(
            target=self._health_check_loop, daemon=True, name="gcs-health")
        self._health_thread.start()

    def _sample_metric_gauges(self) -> None:
        """GCS-owned gauges for the metrics harvest. The wait-graph
        gauges used to be mirrored into the dashboard head's registry
        per scrape (_refresh_wait_graph_metrics); exporting them here
        keeps the Grafana exprs (`ray_tpu_wait_graph_edges`,
        `ray_tpu_deadlocks_detected`) alive on the merged endpoint
        natively."""
        from ray_tpu_torch.util.metrics import Gauge, get_or_create
        snap = self.wait_graph.snapshot()
        get_or_create(
            Gauge, "ray_tpu_wait_graph_edges",
            description="live actor waits-for edges (blocking gets)"
        ).set(float(len(snap["edges"])))
        get_or_create(
            Gauge, "ray_tpu_deadlocks_detected",
            description="waits-for cycles detected since cluster start"
        ).set(float(snap["deadlocks_detected"]))
        get_or_create(
            Gauge, "ray_tpu_wait_graph_max_edge_age_seconds",
            description="age of the oldest live actor wait edge "
                        "(watchdog stuck-wait probe input)"
        ).set(float(snap["max_edge_age_s"]))
        with self._lock:
            alive = sum(1 for n in self.nodes.values() if n.alive)
        get_or_create(
            Gauge, "ray_tpu_alive_nodes",
            description="nodes the GCS currently considers alive"
        ).set(float(alive))
        self._sample_gang_heartbeat_gauge()

    # ---- KV --------------------------------------------------------------

    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        if not overwrite and self.store.get("kv", key) is not None:
            return False
        self.store.put("kv", key, value)
        return True

    def kv_get(self, key: str) -> Optional[bytes]:
        return self.store.get("kv", key)

    def kv_del(self, key: str) -> bool:
        return self.store.delete("kv", key)

    def kv_keys(self, prefix: str = "") -> List[str]:
        return self.store.keys("kv", prefix)

    def kv_exists(self, key: str) -> bool:
        return self.store.get("kv", key) is not None

    # ---- nodes -----------------------------------------------------------

    def register_node(self, info: NodeInfo) -> None:
        with self._lock:
            hex_id = info.node_id.hex()
            prev = self.nodes.get(hex_id)
            self.nodes[hex_id] = info
            # a RE-register of a live node (idempotent retry / blip
            # recovery) must not clobber its real availability with the
            # full total — busy nodes would look free until the next
            # report tick
            if prev is None or not prev.alive or \
                    hex_id not in self.node_available:
                self.node_available[hex_id] = dict(info.resources_total)
        self.publish("node", ("ALIVE", info))

    def unregister_node(self, node_id_hex: str) -> None:
        self._mark_node_dead(node_id_hex, "unregistered")

    def _mark_node_dead(self, node_id_hex: str, reason: str) -> None:
        with self._lock:
            info = self.nodes.get(node_id_hex)
            if info is None or not info.alive:
                return
            info.alive = False
            self.node_available.pop(node_id_hex, None)
            dead_actors = [a for a in self.actors.values()
                           if a.node_id and a.node_id.hex() == node_id_hex
                           and a.state in ("ALIVE", "PENDING", "RESTARTING")]
        log = logger.info if reason == "unregistered" else logger.warning
        log("GCS: node %s dead (%s)", node_id_hex[:12], reason)
        self._emit("NODE_DEAD", reason,
                   severity="INFO" if reason == "unregistered"
                   else "WARNING", node_id=node_id_hex)
        self.publish("node", ("DEAD", info))
        for a in dead_actors:
            self.report_actor_death(a.actor_id.hex(),
                                    f"node {node_id_hex[:12]} died", restart=True)

    def get_all_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return list(self.nodes.values())

    def report_resources(self, node_id_hex: str,
                         available: Dict[str, float],
                         version: int = 0) -> str:
        with self._lock:
            if node_id_hex in self.nodes and self.nodes[node_id_hex].alive:
                # versioned, change-triggered reports (reference
                # RaySyncer ray_syncer.h:88): drop stale out-of-order
                # updates; version resets (node-manager restart) accept
                last = self.node_resource_version.get(node_id_hex, 0)
                if version and version < last and version > 1:
                    return "ok"  # stale in-flight report
                self.node_resource_version[node_id_hex] = version
                self.node_available[node_id_hex] = dict(available)
                self.node_health_failures[node_id_hex] = 0
                return "ok"
        # a restarted GCS (or one that declared this node dead during a
        # network blip) doesn't know the reporter: tell it to
        # re-register (reference: raylets reconnect after GCS restart,
        # NotifyGCSRestart node_manager.proto:357)
        return "unknown_node"

    def get_cluster_resources(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        with self._lock:
            return {
                nid: {"total": dict(self.nodes[nid].resources_total),
                      "available": dict(avail)}
                for nid, avail in self.node_available.items()
                if self.nodes[nid].alive}

    def _health_check_loop(self) -> None:
        # reference: gcs_health_check_manager.h — active raylet health probes
        while not self._dead:
            time.sleep(self.HEALTH_CHECK_PERIOD_S)
            with self._lock:
                targets = [(nid, n.address) for nid, n in self.nodes.items()
                           if n.alive]
            for nid, addr in targets:
                try:
                    self._pool.get(addr).call("nm_ping")
                    with self._lock:
                        self.node_health_failures[nid] = 0
                except Exception:  # noqa: BLE001
                    with self._lock:
                        self.node_health_failures[nid] = \
                            self.node_health_failures.get(nid, 0) + 1
                        failures = self.node_health_failures[nid]
                    self._pool.invalidate(addr)
                    if failures >= self.HEALTH_CHECK_FAILURES_TO_DEAD:
                        self._mark_node_dead(nid, "health check failed")

    # ---- jobs ------------------------------------------------------------

    def next_job_id(self) -> JobID:
        with self._lock:
            # persisted so job ids stay unique across GCS restarts
            counter = (self.store.get("meta", "job_counter") or 0) + 1
            self.store.put("meta", "job_counter", counter)
            self.job_counter = counter
            return JobID(self.job_counter.to_bytes(4, "big"))

    # ---- actors ----------------------------------------------------------

    def _persist_actor(self, actor_id_hex: str) -> None:
        """Write one actor's directory record + the named map to the
        store so lookups survive a GCS restart (reference
        GcsActorTable, gcs_table_storage.h:48). Stores a snapshot COPY:
        the live ActorInfo keeps mutating under the GCS lock while the
        persistence flusher pickles tables under the store lock."""
        import copy
        with self._lock:
            info = self.actors.get(actor_id_hex)
            spec = self.actor_specs.get(actor_id_hex)
            named = dict(self.named_actors)
            info = copy.copy(info) if info is not None else None
        if info is not None:
            self.store.put("actors", actor_id_hex, (info, spec))
            self.store.put("meta", "named_actors", named)

    def register_actor(self, spec: TaskSpec, name: str = "",
                       namespace: str = "") -> str:
        """Register + schedule an actor creation (reference
        GcsActorManager::HandleRegisterActor + GcsActorScheduler)."""
        actor_id = spec.actor_id
        assert actor_id is not None
        key = (namespace, name)
        with self._lock:
            if name:
                existing = self.named_actors.get(key)
                existing_info = (self.actors.get(existing)
                                 if existing is not None else None)
                if existing_info is not None and \
                        existing_info.state != "DEAD":
                    raise ValueError(
                        f"actor name '{name}' already taken in ns '{namespace}'")
                self.named_actors[key] = actor_id.hex()
            self.actors[actor_id.hex()] = ActorInfo(
                actor_id=actor_id, name=name, namespace=namespace,
                class_name=spec.function_name, state="PENDING", address=None,
                node_id=None, max_restarts=spec.max_restarts)
            self.actor_specs[actor_id.hex()] = spec
        self._persist_actor(actor_id.hex())
        # Schedule asynchronously so registration returns immediately
        # (reference: GcsActorManager registers then hands to the scheduler).
        threading.Thread(target=self._schedule_actor,
                         args=(actor_id.hex(),), daemon=True).start()
        return actor_id.hex()

    def _pick_node_for(self, required: ResourceSet,
                       spec: TaskSpec) -> Optional[str]:
        from ray_tpu_torch._private.scheduler import pick_node
        with self._lock:
            view = {nid: dict(avail) for nid, avail in self.node_available.items()
                    if self.nodes[nid].alive}
            labels = {nid: dict(self.nodes[nid].labels) for nid in view}
        return pick_node(view, required, spec.scheduling_strategy,
                         local_node_id=None, labels=labels,
                         locality_hints=spec.locality_hints)

    def _schedule_actor(self, actor_id_hex: str) -> None:
        spec = self.actor_specs[actor_id_hex]
        # PG-scheduled actors are feasible ONLY on the node holding the
        # committed bundle: match on the bundle-scoped resource names
        # (the same rewrite the target node manager checks in
        # _effective_resources) — raw resources would make every node
        # "feasible" and pin the retry loop to a node that can never
        # accept the actor.
        from ray_tpu_torch._private.node_manager import rewrite_resources_for_pg
        from ray_tpu_torch._private.state import PlacementGroupSchedulingStrategy
        if isinstance(spec.scheduling_strategy,
                      PlacementGroupSchedulingStrategy) and \
                spec.placement_group_id is not None:
            required = ResourceSet(rewrite_resources_for_pg(
                spec.resources, spec.placement_group_id.hex(),
                spec.placement_group_bundle_index))
        else:
            required = spec.required_resources()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            node_id_hex = self._pick_node_for(required, spec)
            if node_id_hex is None:
                time.sleep(0.1)
                continue
            with self._lock:
                node = self.nodes.get(node_id_hex)
            if node is None or not node.alive:
                continue
            try:
                ok = self._pool.get(node.address).call(
                    "nm_schedule_actor_creation", spec=spec)
            except Exception:  # noqa: BLE001
                ok = False
            if ok:
                with self._lock:
                    info = self.actors[actor_id_hex]
                    info.node_id = node.node_id
                return
            time.sleep(0.05)
        self.report_actor_death(actor_id_hex,
                                "scheduling timed out (infeasible?)",
                                restart=False)

    def report_actor_alive(self, actor_id_hex: str,
                           address: Tuple[str, int],
                           node_id_hex: str) -> None:
        with self._lock:
            info = self.actors.get(actor_id_hex)
            if info is None:
                return
            info.state = "ALIVE"
            info.address = tuple(address)
            info.node_id = NodeID.from_hex(node_id_hex)
        self._persist_actor(actor_id_hex)
        self.publish("actor", ("ALIVE", self.actors[actor_id_hex]))

    def report_actor_death(self, actor_id_hex: str, reason: str,
                           restart: bool = True) -> None:
        with self._lock:
            info = self.actors.get(actor_id_hex)
            if info is None or info.state == "DEAD":
                return
            can_restart = (restart and
                           (info.max_restarts == -1
                            or info.num_restarts < info.max_restarts))
            # Always record the latest death reason — even when restarting —
            # so a later terminal DEAD (e.g. restart-scheduling failure with
            # a vague reason) still surfaces what originally killed the actor.
            info.death_cause = reason or info.death_cause or "(unknown cause)"
            if can_restart:
                info.state = "RESTARTING"
                info.num_restarts += 1
                info.address = None
            else:
                info.state = "DEAD"
                info.address = None
        self._persist_actor(actor_id_hex)
        # a dead actor's blocking gets died with it; waiters on it get
        # ActorDiedError through the usual path, not a stale wait edge
        self.wait_graph.drop_actor(actor_id_hex)
        if can_restart:
            logger.warning("GCS: restarting actor %s (%d/%s): %s",
                           actor_id_hex[:12], info.num_restarts,
                           info.max_restarts, reason)
            self._emit("ACTOR_RESTARTING", reason, severity="WARNING",
                       actor_id=actor_id_hex,
                       restart=info.num_restarts)
            self.publish("actor", ("RESTARTING", info))
            threading.Thread(target=self._schedule_actor,
                             args=(actor_id_hex,), daemon=True).start()
        else:
            self._emit("ACTOR_DEAD", info.death_cause, severity="INFO",
                       actor_id=actor_id_hex)
            self.publish("actor", ("DEAD", info))

    def get_actor_info(self, actor_id_hex: str) -> Optional[ActorInfo]:
        with self._lock:
            return self.actors.get(actor_id_hex)

    def get_named_actor(self, name: str, namespace: str = ""
                        ) -> Optional[ActorInfo]:
        with self._lock:
            aid = self.named_actors.get((namespace, name))
            return self.actors.get(aid) if aid else None

    def list_named_actors(self, namespace: str = "", all_namespaces: bool = False
                          ) -> List[Tuple[str, str]]:
        with self._lock:
            return [k for k, aid in self.named_actors.items()
                    if (all_namespaces or k[0] == namespace)
                    and aid in self.actors
                    and self.actors[aid].state != "DEAD"]

    def list_actors(self) -> List[ActorInfo]:
        with self._lock:
            return list(self.actors.values())

    def kill_actor(self, actor_id_hex: str, no_restart: bool = True) -> None:
        with self._lock:
            info = self.actors.get(actor_id_hex)
            addr = info.address if info else None
        if addr is not None:
            try:
                self._pool.get(addr).call("cw_kill_self")
            except Exception:  # noqa: BLE001 - death report below still lands
                pass
        self.report_actor_death(actor_id_hex, "ray.kill", restart=not no_restart)

    # ---- task events (reference GcsTaskManager) -------------------------

    TASK_EVENTS_MAX = 16384

    def add_task_events(self, events: List[Dict[str, Any]]) -> None:
        with self._lock:
            for rec in events:
                tid = rec.get("task_id")
                if not tid:
                    continue
                existing = self.task_events.get(tid)
                if existing is None:
                    self.task_events[tid] = dict(rec)
                else:
                    # Terminal states must not be clobbered by a late-arriving
                    # RUNNING delta from the executing worker's buffer.
                    if existing.get("state") in ("FINISHED", "FAILED"):
                        rec = {k: v for k, v in rec.items() if k != "state"}
                    existing.update(rec)
            while len(self.task_events) > self.TASK_EVENTS_MAX:
                self.task_events.popitem(last=False)
                self.task_events_dropped += 1

    def list_tasks(self, filters: Optional[Dict[str, Any]] = None,
                   limit: int = 10000) -> List[Dict[str, Any]]:
        with self._lock:
            records = list(self.task_events.values())
        if filters:
            records = [r for r in records
                       if all(r.get(k) == v for k, v in filters.items())]
        return records[-limit:]

    # ---- flight recorder (see _private/spans.py) ------------------------

    SPANS_COLLECT_TIMEOUT_S = 5.0

    def spans_collect(self) -> List[Dict[str, Any]]:
        """Fan a snapshot request out to every process and gather the
        span rings: this process, every node manager (which gathers its
        own workers), and every pubsub subscriber (drivers live outside
        any node manager's worker table). Each snapshot is annotated
        with `clock_offset_s` — the RPC-midpoint estimate of
        peer_wall_clock - gcs_wall_clock — so the merger can align all
        processes onto one timebase. Best-effort: unreachable processes
        just drop out of the trace."""
        from ray_tpu_torch._private import spans as spans_lib
        own = spans_lib.snapshot()
        own["clock_offset_s"] = 0.0
        # a process can be reached twice (subscribed workers also appear
        # in their node manager's table); dedupe is by proc uid with a
        # deterministic preference: own ring (offset exactly 0), then
        # direct core-worker estimates, then NM-chained ones (two
        # estimation hops)
        direct: List[Dict[str, Any]] = []
        via_nm: List[Dict[str, Any]] = []
        # Two-phase gather shared with the metrics plane: node managers
        # first (each gathers its own workers), so the subscriber phase
        # skips every worker an NM already shipped — workers also sit in
        # `subscribers`, and pulling them directly too would transfer
        # each ring twice just to dedupe by proc uid.
        nm_replies, cw_replies, _unreachable = \
            spans_lib.gather_cluster_snapshots(
                self, "nm_spans_snapshot", "cw_spans_snapshot",
                timeout=self.SPANS_COLLECT_TIMEOUT_S, grace_s=2.0)
        for _addr, reply, t0, _t1 in nm_replies:
            # offset of the NM's wall clock vs ours; the NM already
            # stamped each of its workers relative to ITS clock. The NM
            # stamps wall_time at handler ENTRY (its own worker gather
            # can take seconds, so the usual RPC-midpoint reference
            # would be skewed by half the gather) — the reference point
            # is t0 + one-way network latency.
            # cross-process clock-offset estimation is the one place a
            # wall-clock difference is the point (monotonic clocks are
            # not comparable across processes/hosts).
            offset = reply["wall_time"] - t0
            for snap in reply["snapshots"]:
                snap["clock_offset_s"] = \
                    snap.get("clock_offset_s", 0.0) + offset
                via_nm.append(snap)
        for _addr, snap, t0, t1 in cw_replies:
            snap["clock_offset_s"] = snap["wall_time"] - (t0 + t1) / 2.0
            direct.append(snap)
        return spans_lib.dedupe_by_uid([own] + direct + via_nm)

    # ---- profiling plane (see _private/profiler.py) ---------------------

    PROFILE_COLLECT_GRACE_S = 8.0

    def profile_collect(self, duration_s: float = 5.0, hz: float = 100.0,
                        device: bool = False) -> Dict[str, Any]:
        """Cluster profile: start→sleep→snapshot on every process —
        node managers (each covers its workers one hop below) and
        pubsub-subscribed drivers — CONCURRENTLY under one overall
        deadline, so every process samples the same window and an
        unreachable node bounds, not doubles, the collect. A process
        reached twice (NM gather + direct subscriber pull) runs ONE
        sampling session (profiler.collect_local singleflight) and is
        deduped by proc uid here. The merge downstream is clock-free:
        folded-stack counts, never timestamps."""
        from ray_tpu_torch._private import profiler as profiler_lib
        from ray_tpu_torch._private import spans as spans_lib
        duration_s = min(120.0, max(0.05, float(duration_s)))
        own_box: List[Optional[Dict[str, Any]]] = [None]

        def _own() -> None:
            try:
                own_box[0] = profiler_lib.collect_local(duration_s, hz)
            except Exception:  # noqa: BLE001 - the control plane's own
                pass           # profile is optional in the merge

        own_thread = None
        if not device:
            # sample this process too (in-process head: GCS + NM +
            # driver share it; the singleflight collapses the sessions)
            own_thread = threading.Thread(target=_own, daemon=True,
                                          name="gcs-profile-own")
            own_thread.start()
        nm_replies, cw_replies, unreachable = \
            spans_lib.gather_cluster_snapshots(
                self, "nm_profile_collect", "cw_profile_collect",
                timeout=duration_s + self.PROFILE_COLLECT_GRACE_S + (
                    profiler_lib.device_export_s(duration_s) if device
                    else 0.0),
                grace_s=2.0, concurrent=True,
                call_kwargs={"duration_s": duration_s, "hz": hz,
                             "device": device})
        profiles: List[Dict[str, Any]] = []
        for _addr, reply, _t0, _t1 in nm_replies:
            profiles.extend(reply.get("profiles", ()))
        profiles.extend(snap for _a, snap, _t0, _t1 in cw_replies)
        if own_thread is not None:
            own_thread.join(timeout=duration_s + 5.0)
        if own_box[0] is not None:
            profiles.insert(0, own_box[0])
        profiles = spans_lib.dedupe_by_uid([p for p in profiles if p])
        return {"ts": time.time(), "duration_s": duration_s, "hz": hz,
                "device": device, "profiles": profiles,
                "unreachable": unreachable}

    # ---- memory attribution plane (see _private/memory_plane.py) --------

    MEMORY_COLLECT_TIMEOUT_S = 5.0

    def memory_collect(self, max_objects: Optional[int] = None,
                       timeout: Optional[float] = None) -> Dict[str, Any]:
        """Cluster object table: every core worker's reference-table
        snapshot joined with every node's store residency under one
        overall deadline (memory_plane.build_object_table). Reply names
        the nodes that did not answer — absence of a row is only
        meaningful when coverage was complete."""
        from ray_tpu_torch._private import memory_plane as memory_plane_lib
        from ray_tpu_torch._private import spans as spans_lib
        t = float(timeout) if timeout else self.MEMORY_COLLECT_TIMEOUT_S
        call_kwargs = {"max_objects": max_objects} \
            if max_objects is not None else None
        nm_replies, cw_replies, unreachable = \
            spans_lib.gather_cluster_snapshots(
                self, "nm_memory_snapshot", "cw_memory_snapshot",
                timeout=t, grace_s=1.0, call_kwargs=call_kwargs)
        proc_snaps: List[Dict[str, Any]] = []
        node_snaps: List[Dict[str, Any]] = []
        for _addr, reply, _t0, _t1 in nm_replies:
            node_snaps.append(reply)
            proc_snaps.extend(reply.get("worker_snaps", ()))
        proc_snaps.extend(snap for _a, snap, _t0, _t1 in cw_replies)
        proc_snaps = spans_lib.dedupe_by_uid(proc_snaps)
        rows = memory_plane_lib.build_object_table(proc_snaps,
                                                   node_snaps)
        return {"ts": time.time(), "objects": rows,
                "procs": len(proc_snaps),
                "objects_dropped": sum(
                    int(s.get("objects_dropped") or 0)
                    for s in proc_snaps),
                "unreachable": unreachable}

    # ---- ownership protocol plane (see _private/ownership.py) -----------

    OWNERSHIP_COLLECT_TIMEOUT_S = 5.0

    def ownership_collect(self, object_id: Optional[str] = None,
                          limit: int = 200,
                          timeout: Optional[float] = None
                          ) -> Dict[str, Any]:
        """Cluster ownership gather: every process's RefState/LeaseState
        view + transition-ring tail (node managers bundle their store's
        leased/pinned entries and held NM leases; workers and drivers
        answer directly) under one overall deadline. Reply names the
        nodes that did not answer — a missing claimant is only
        meaningful when coverage was complete."""
        from ray_tpu_torch._private import spans as spans_lib
        t = float(timeout) if timeout else self.OWNERSHIP_COLLECT_TIMEOUT_S
        kwargs: Dict[str, Any] = {"limit": limit}
        if object_id is not None:
            kwargs["object_id"] = object_id
        nm_replies, cw_replies, unreachable = \
            spans_lib.gather_cluster_snapshots(
                self, "nm_ownership_snapshot", "cw_ownership_snapshot",
                timeout=t, grace_s=1.0, call_kwargs=kwargs)
        proc_snaps: List[Dict[str, Any]] = []
        node_snaps: List[Dict[str, Any]] = []
        for _addr, reply, _t0, _t1 in nm_replies:
            node_snaps.append({k: v for k, v in reply.items()
                               if k != "worker_snaps"})
            proc_snaps.extend(reply.get("worker_snaps", ()))
        proc_snaps.extend(snap for _a, snap, _t0, _t1 in cw_replies)
        proc_snaps = spans_lib.dedupe_by_uid(proc_snaps)
        # anomaly totals dedupe by PROCESS, not snapshot: with an
        # in-process head node the NM and the driver share one
        # transition ring, and summing both snapshots would double-count
        # every event (per-uid max: the two reads race the same
        # monotonically-growing counters)
        per_uid: Dict[Any, Dict[str, int]] = {}
        for snap in proc_snaps + node_snaps:
            uid = snap.get("proc_uid")
            tgt = per_uid.setdefault(uid, {})
            for ev, n in (snap.get("anomalies") or {}).items():
                tgt[ev] = max(tgt.get(ev, 0), int(n))
        anomalies: Dict[str, int] = {}
        for counts in per_uid.values():
            for ev, n in counts.items():
                anomalies[ev] = anomalies.get(ev, 0) + n
        return {"ts": time.time(), "procs": proc_snaps,
                "nodes": node_snaps, "anomalies": anomalies,
                "unreachable": unreachable}

    # ---- lockdep plane (see ray_tpu/util/locks.py) ----------------------

    LOCKS_COLLECT_TIMEOUT_S = 5.0

    def locks_collect(self, timeout: Optional[float] = None
                      ) -> Dict[str, Any]:
        """Cluster lock-plane gather: every process's traced-lock
        snapshot (per-name hold stats + waiters + holder attribution +
        acquisition-order edge graph with any cycle) over the shared
        two-phase fan-out, under one overall deadline. Reply names the
        nodes that did not answer."""
        from ray_tpu_torch._private import spans as spans_lib
        from ray_tpu_torch.util import locks as locks_lib
        t = float(timeout) if timeout else self.LOCKS_COLLECT_TIMEOUT_S
        own = locks_lib.snapshot()
        nm_replies, cw_replies, unreachable = \
            spans_lib.gather_cluster_snapshots(
                self, "nm_locks_snapshot", "cw_locks_snapshot",
                timeout=t, grace_s=1.0)
        gathered: List[Dict[str, Any]] = []
        for _addr, reply, _t0, _t1 in nm_replies:
            gathered.extend(reply.get("snapshots", ()))
        gathered.extend(snap for _a, snap, _t0, _t1 in cw_replies)
        procs = spans_lib.dedupe_by_uid([own] + gathered)
        return {"ts": time.time(), "procs": procs,
                "unreachable": unreachable}

    # ---- debug plane: log fan-out + postmortems (log_plane.py) ----------

    LOGS_COLLECT_TIMEOUT_S = 5.0

    def logs_query(self, filters: Optional[Dict[str, Any]] = None,
                   tail: int = 500,
                   timeout: Optional[float] = None) -> Dict[str, Any]:
        """Cluster log query: ONE fan-out round over the same two-phase
        gather the span/metrics planes use (node managers first — each
        serves its whole node's tail index, filtered server-side — then
        remaining pubsub subscribers, i.e. drivers), all under a single
        overall deadline so an unreachable node bounds, not doubles,
        the query's worst case. Returns ts-merged records trimmed to
        `tail` plus the node ids that did not answer."""
        from ray_tpu_torch._private import spans as spans_lib
        t = float(timeout) if timeout else self.LOGS_COLLECT_TIMEOUT_S
        nm_replies, cw_replies, unreachable = \
            spans_lib.gather_cluster_snapshots(
                self, "nm_logs_snapshot", "cw_logs_snapshot",
                timeout=t, grace_s=1.0,
                call_kwargs={"filters": filters, "tail": tail})
        records: List[Dict[str, Any]] = []
        for _addr, reply, _t0, _t1 in nm_replies:
            records.extend(reply.get("records", ()))
        seen: set = set()
        for _addr, snap, _t0, _t1 in cw_replies:
            uid = snap.get("proc_uid")
            if uid in seen:
                continue
            seen.add(uid)
            records.extend(snap.get("records", ()))
        records.sort(key=lambda r: (r.get("ts") or 0.0, r.get("seq", 0)))
        if tail:
            records = records[-int(tail):]
        return {"records": records, "unreachable": unreachable}

    def postmortem_report(self, bundle: Dict[str, Any]) -> str:
        pm_id = bundle.get("postmortem_id") or f"pm-{os.urandom(6).hex()}"
        bundle["postmortem_id"] = pm_id
        with self._lock:
            self.postmortems[pm_id] = bundle
            while len(self.postmortems) > self.POSTMORTEMS_MAX:
                self.postmortems.popitem(last=False)
        self._emit("POSTMORTEM_CAPTURED",
                   f"{bundle.get('kind', 'crash')} postmortem {pm_id}: "
                   f"{str(bundle.get('reason', ''))[:200]}",
                   severity="WARNING", postmortem_id=pm_id,
                   node_id=bundle.get("node_id"),
                   worker_id=bundle.get("worker_id"))
        return pm_id

    def postmortem_list(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Newest-last summaries (without the bulky tails — fetch one
        by id for the full bundle)."""
        if limit <= 0:
            return []
        with self._lock:
            bundles = list(self.postmortems.values())[-limit:]
        return [{k: v for k, v in b.items()
                 if k not in ("log_tail", "span_tail")}
                | {"log_lines": len(b.get("log_tail") or ()),
                   "span_records": len(b.get("span_tail") or ())}
                for b in bundles]

    def postmortem_get(self, postmortem_id: str
                       ) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self.postmortems.get(postmortem_id)

    # ---- structured events (reference util/event.h sink) ----------------

    def add_events(self, events: List[Dict[str, Any]]) -> None:
        with self._lock:
            self.cluster_events.extend(events)
            overflow = len(self.cluster_events) - self.CLUSTER_EVENTS_MAX
            if overflow > 0:
                del self.cluster_events[:overflow]

    def list_events(self, event_type: Optional[str] = None,
                    severity: Optional[str] = None,
                    limit: int = 1000) -> List[Dict[str, Any]]:
        if limit <= 0:  # out[-0:] would mean "everything"
            return []
        with self._lock:
            out = list(self.cluster_events)
        if event_type:
            out = [e for e in out if e.get("event_type") == event_type]
        if severity:
            out = [e for e in out if e.get("severity") == severity]
        return out[-limit:]

    # ---- autoscaler v2 lifecycle plane (autoscaler/v2.py) ---------------

    def autoscaler_v2_report(self, instances: List[Dict[str, Any]],
                             events: List[Dict[str, Any]]) -> None:
        """One report per autoscaler pass: replace the instance table,
        append lifecycle transitions to the bounded ring, mirror each
        into the cluster event log, and push it on the
        "autoscaler_lifecycle" pubsub channel so elastic trainers can
        react to membership changes without polling."""
        with self._lock:
            self.autoscaler_instances = list(instances)
            self.autoscaler_events.extend(events)
            overflow = (len(self.autoscaler_events)
                        - self.AUTOSCALER_EVENTS_MAX)
            if overflow > 0:
                del self.autoscaler_events[:overflow]
        for evt in events:
            self._emit(
                "AUTOSCALER_INSTANCE",
                f"instance {evt.get('instance_id', '?')} "
                f"({evt.get('node_type', '?')}): "
                f"{evt.get('from', '?')} -> {evt.get('to', '?')}"
                + (f" ({evt['reason']})" if evt.get("reason") else ""),
                **{k: v for k, v in evt.items() if k != "ts"})
            self.publish("autoscaler_lifecycle", evt)

    def autoscaler_v2_state(self, limit: int = 200) -> Dict[str, Any]:
        with self._lock:
            return {"instances": list(self.autoscaler_instances),
                    "events": list(self.autoscaler_events[-limit:])}

    # ---- actor waits-for graph (deadlock detection) ---------------------

    def wait_graph_add(self, waiter_hex: str, target_hex: str,
                       token: str) -> Optional[List[Dict[str, str]]]:
        """Register a blocking-get edge. Returns None (edge recorded) or
        the cycle the edge would close, annotated with class names, in
        which case the edge is NOT recorded and the caller must raise
        DeadlockError instead of blocking. Idempotent per token (safe
        under RPC retry)."""
        cycle = self.wait_graph.add(waiter_hex, target_hex, token)
        if cycle is None:
            return None
        from ray_tpu_torch._private.wait_graph import format_cycle
        with self._lock:
            names = {h: self.actors[h].class_name
                     for h in cycle if h in self.actors}
        self._emit("DEADLOCK_DETECTED", format_cycle(cycle, names),
                   severity="ERROR", cycle=list(cycle))
        return [{"actor_id": h, "class_name": names.get(h, "")}
                for h in cycle]

    def wait_graph_remove(self, token: str) -> None:
        self.wait_graph.remove(token)

    def wait_graph_snapshot(self) -> Dict[str, Any]:
        return self.wait_graph.snapshot()

    # ---- gang heartbeat plane (train/heartbeat.py) ----------------------

    def gang_heartbeat(self, gang: str, rank: int, step: int = 0,
                       phase: str = "", node_id: str = "",
                       pid: int = 0) -> None:
        """One rank beat (oneway from the worker sidecar). Stamped with
        THIS process's monotonic clock: age is computed at query time
        against the same clock, so no cross-host time agreement is
        needed and a paused sender reads exactly as a growing age."""
        with self._lock:
            gang_tbl = self.gang_heartbeats_tbl.get(gang)
            if gang_tbl is None:
                while len(self.gang_heartbeats_tbl) >= \
                        self.GANG_HEARTBEAT_GANGS_MAX:
                    self.gang_heartbeats_tbl.popitem(last=False)
                gang_tbl = self.gang_heartbeats_tbl[gang] = {}
            gang_tbl[int(rank)] = {
                "step": int(step), "phase": phase, "node_id": node_id,
                "pid": int(pid), "recv_mono": time.monotonic()}

    def gang_heartbeats(self, gang: str) -> Dict[str, Any]:
        """Per-rank heartbeat ages for one gang, enriched with each
        rank's NM RPC address (NodeInfo.address) so the supervisor can
        hard-kill a wedged pid without an extra lookup, plus the
        runtime step-deadline override (metrics_configure) so the
        deadline stays tunable without touching the trainer."""
        now = time.monotonic()
        with self._lock:
            ranks: Dict[int, Dict[str, Any]] = {}
            for rank, rec in (self.gang_heartbeats_tbl.get(gang)
                              or {}).items():
                node = self.nodes.get(rec["node_id"])
                ranks[rank] = {
                    "step": rec["step"], "phase": rec["phase"],
                    "node_id": rec["node_id"], "pid": rec["pid"],
                    "nm_address": list(node.address)
                    if node is not None and node.alive else None,
                    "age_s": max(0.0, now - rec["recv_mono"]),
                }
        plane = getattr(self, "metrics_plane", None)
        override = getattr(plane, "step_deadline_override_s", None)
        return {"gang": gang, "ranks": ranks,
                "step_deadline_override_s": override}

    def gang_heartbeat_clear(self, gang: str) -> bool:
        with self._lock:
            return self.gang_heartbeats_tbl.pop(gang, None) is not None

    # A row this stale is an ABANDONED formation, not a wedge: any real
    # wedge is detected and torn down by its gang supervisor within the
    # step deadline (seconds), and a clean teardown clears the rows. A
    # supervisor that died without cleanup (crashed driver, failed test
    # run) leaves rows that would otherwise read as wedged-forever to
    # the watchdog. GC'd here rather than on a timer of their own so
    # the table stays bounded on the always-on GCS.
    GANG_HEARTBEAT_ABANDON_S = 120.0

    def _gang_heartbeat_rows(self) -> List[Tuple[str, int, float]]:
        """Live (gang, rank, age_s) rows from the heartbeat table —
        shared by the harvest gauge export and the metrics plane's
        liveness tick (which must NOT wait for a harvest: a wedged
        worker stalls the fan-out by design). Rows past the abandon
        horizon are dropped, not reported."""
        now = time.monotonic()
        dropped: List[Tuple[str, int]] = []
        with self._lock:
            out = []
            for gang, tbl in list(self.gang_heartbeats_tbl.items()):
                for rank, rec in list(tbl.items()):
                    age = max(0.0, now - rec["recv_mono"])
                    if age > self.GANG_HEARTBEAT_ABANDON_S:
                        del tbl[rank]
                        dropped.append((gang, rank))
                        continue
                    out.append((gang, rank, age))
                if not tbl:
                    self.gang_heartbeats_tbl.pop(gang, None)
        for gang, rank in dropped:
            logger.info(
                "dropping abandoned gang heartbeat row %s rank %d "
                "(stale > %.0fs; its formation was torn down without "
                "a clear, or its supervisor died)", gang, rank,
                self.GANG_HEARTBEAT_ABANDON_S)
        return out

    def gang_heartbeat_age_series(self) -> Dict[str, float]:
        """The heartbeat ages as flat watchdog series keys (same
        `name{gang=...,rank=...}` shape the aggregator produces), so
        the liveness tick feeds _probe_gang_wedge the exact input the
        harvested gauge would — one probe, two cadences."""
        return {f"ray_tpu_gang_heartbeat_age_seconds"
                f"{{gang={gang},rank={rank}}}": age
                for gang, rank, age in self._gang_heartbeat_rows()}

    def _sample_gang_heartbeat_gauge(self) -> None:
        """Export ray_tpu_gang_heartbeat_age_seconds{gang,rank} on each
        harvest. Rebuild-per-sample (reset then set the live rows): the
        tag population is dynamic, and a lingering series for a cleared
        gang would read as wedged-forever to the watchdog probe."""
        from ray_tpu_torch.util.metrics import Gauge, get_or_create
        rows = self._gang_heartbeat_rows()
        g = get_or_create(
            Gauge, "ray_tpu_gang_heartbeat_age_seconds",
            description="seconds since each gang rank's last heartbeat "
                        "(sidecar beats every ~0.5s; a growing age is a "
                        "wedged/stopped rank)",
            tag_keys=("gang", "rank"))
        g.reset()
        for gang, rank, age in rows:
            g.set(age, tags={"gang": gang, "rank": str(rank)})

    # ---- chaos plane (_private/chaos.py) --------------------------------

    def _chaos_policy_locked(self) -> Dict[str, Any]:
        return {"version": self.chaos_version,
                "rules": [dict(r) for r in self.chaos_rules.values()]}

    def _chaos_publish(self) -> None:
        """Push the policy to every subscriber AND install it into this
        process's own chaos client (the GCS's RPC server is a hook point
        too; in-process head nodes share this client with the driver)."""
        with self._lock:
            policy = self._chaos_policy_locked()
        from ray_tpu_torch._private import chaos as chaos_lib
        chaos_lib.client().install(policy)
        self.publish("chaos", policy)

    def chaos_inject(self, rules: List[Dict[str, Any]]) -> List[str]:
        """Append rules to the policy (ordered). Fills in each rule's
        node-address map from the live node table so partition /
        node-targeted rules can match peer addresses, then distributes
        the bumped policy over pubsub."""
        from ray_tpu_torch._private.chaos import FAULT_TYPES, ChaosRule
        with self._lock:
            node_addrs = {
                nid: [tuple(n.address), tuple(n.store_address)]
                for nid, n in self.nodes.items() if n.alive}
            ids = []
            for rec in rules:
                rule = ChaosRule.from_dict(rec)
                if rule.fault not in FAULT_TYPES:
                    raise ValueError(
                        f"unknown chaos fault {rule.fault!r} "
                        f"(one of {FAULT_TYPES})")
                if not rule.rule_id:
                    self._chaos_rule_counter += 1
                    rule.rule_id = f"cr-{self._chaos_rule_counter:04d}"
                if not rule.node_addrs:
                    rule.node_addrs = node_addrs
                self.chaos_rules[rule.rule_id] = rule.to_dict()
                self.chaos_fired.setdefault(rule.rule_id, 0)
                ids.append(rule.rule_id)
            self.chaos_version += 1
        for rid in ids:
            self._emit("CHAOS_RULE_INSTALLED",
                       f"chaos rule {rid} installed", severity="WARNING",
                       rule_id=rid,
                       fault=self.chaos_rules[rid]["fault"])
        self._chaos_publish()
        return ids

    def chaos_clear(self, rule_ids: Optional[List[str]] = None) -> int:
        with self._lock:
            doomed = list(self.chaos_rules) if rule_ids is None \
                else [r for r in rule_ids if r in self.chaos_rules]
            for rid in doomed:
                del self.chaos_rules[rid]
            if doomed:
                self.chaos_version += 1
        if doomed:
            self._chaos_publish()
        return len(doomed)

    def chaos_list(self) -> Dict[str, Any]:
        with self._lock:
            return {"version": self.chaos_version,
                    "rules": [{**dict(r), "fired": self.chaos_fired.get(
                        rid, 0)} for rid, r in self.chaos_rules.items()]}

    def chaos_get_policy(self) -> Dict[str, Any]:
        with self._lock:
            return self._chaos_policy_locked()

    def chaos_report_fired(self, rule_id: str, fault: str = "",
                           where: str = "", node_id: str = "") -> None:
        """A process fired a rule: aggregate the count, audit it as a
        cluster event, and retire the rule cluster-wide once its
        max_fires budget is spent (per-process counters alone can't
        bound fires across worker restarts)."""
        disable = False
        with self._lock:
            self.chaos_fired[rule_id] = \
                self.chaos_fired.get(rule_id, 0) + 1
            rule = self.chaos_rules.get(rule_id)
            if rule is not None and rule.get("max_fires", -1) >= 0 and \
                    self.chaos_fired[rule_id] >= rule["max_fires"]:
                rule["disabled"] = True
                self.chaos_version += 1
                disable = True
        self._emit("CHAOS_FAULT_INJECTED",
                   f"chaos rule {rule_id} fired {fault} at {where}",
                   severity="WARNING", rule_id=rule_id, fault=fault,
                   node_id=node_id)
        if disable:
            logger.warning("chaos: rule %s reached max_fires; disabling "
                           "cluster-wide", rule_id)
            self._chaos_publish()

    def _emit(self, event_type: str, message: str,
              severity: str = "INFO", **fields: Any) -> None:
        from ray_tpu_torch._private.events import build_event
        self.add_events([build_event("gcs", event_type, message,
                                     severity, **fields)])

    # ---- pubsub ----------------------------------------------------------

    # ---- placement groups (reference GcsPlacementGroupManager,
    #      gcs_placement_group_scheduler.h: 2-phase prepare/commit) -------

    def create_placement_group(self, pg_id_hex: str, bundles, strategy: str,
                               name: str = "", detached: bool = False,
                               creator_job_id: str = "") -> str:
        from ray_tpu_torch._private.ids import PlacementGroupID
        info = PlacementGroupInfo(
            pg_id=PlacementGroupID.from_hex(pg_id_hex), name=name,
            bundles=list(bundles), strategy=strategy,
            creator_job_id=creator_job_id, detached=detached)
        with self._lock:
            self.placement_groups[pg_id_hex] = info
        threading.Thread(target=self._schedule_placement_group,
                         args=(pg_id_hex,), daemon=True,
                         name=f"gcs-pg-{pg_id_hex[:8]}").start()
        return pg_id_hex

    def _schedule_placement_group(self, pg_id_hex: str,
                                  deadline_s: float = 120.0) -> None:
        from ray_tpu_torch._private.scheduler import pack_bundles
        info = self.placement_groups[pg_id_hex]
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and not self._dead:
            if info.state == "REMOVED":
                return
            with self._lock:
                view = {nid: dict(avail)
                        for nid, avail in self.node_available.items()
                        if self.nodes[nid].alive}
            placement = pack_bundles(view, info.bundles, info.strategy)
            if placement is None:
                time.sleep(0.1)
                continue
            # Phase 1: prepare every bundle on its node; roll back all on
            # any failure (reference PrepareBundleResources,
            # node_manager.proto:378).
            prepared = []
            ok = True
            for idx, (nid, bundle) in enumerate(
                    zip(placement, info.bundles)):
                node = self.nodes.get(nid)
                try:
                    good = node is not None and node.alive and \
                        self._pool.get(node.address).call(
                            "nm_prepare_bundle", pg_id_hex=pg_id_hex,
                            bundle_index=idx, resources=bundle)
                except Exception:  # noqa: BLE001
                    good = False
                if not good:
                    ok = False
                    break
                prepared.append((node, idx))
            if not ok:
                for node, idx in prepared:
                    try:
                        self._pool.get(node.address).call(
                            "nm_return_bundle", pg_id_hex=pg_id_hex,
                            bundle_index=idx)
                    except Exception:  # noqa: BLE001 - node died; bundles died with it
                        pass
                time.sleep(0.1)
                continue
            # Phase 2: commit (reference CommitBundleResources,
            # node_manager.proto:382).
            for node, idx in prepared:
                try:
                    self._pool.get(node.address).call(
                        "nm_commit_bundle", pg_id_hex=pg_id_hex,
                        bundle_index=idx)
                except Exception:  # noqa: BLE001 - prepare already
                    # reserved the resources; a node dying between
                    # prepare and commit surfaces through its NODE_DEAD
                    # sweep, but the skipped commit must be on record
                    logger.warning(
                        "placement group %s: commit_bundle %d on node "
                        "%s failed", pg_id_hex[:12], idx,
                        node.node_id.hex()[:12], exc_info=True)
            with self._lock:
                # remove_placement_group may have raced us between the
                # top-of-loop check and the commit: it saw PENDING and
                # returned no bundles, so we must release them here rather
                # than resurrect a removed group.
                if info.state == "REMOVED":
                    removed_while_scheduling = True
                else:
                    removed_while_scheduling = False
                    info.bundle_nodes = list(placement)
                    info.state = "CREATED"
            if removed_while_scheduling:
                for node, idx in prepared:
                    try:
                        self._pool.get(node.address).call(
                            "nm_return_bundle", pg_id_hex=pg_id_hex,
                            bundle_index=idx)
                    except Exception:  # noqa: BLE001 - node gone; nothing to return
                        pass
                return
            self.publish("placement_group", ("CREATED", info))
            return
        with self._lock:
            if info.state == "PENDING":
                info.state = "INFEASIBLE"
        self.publish("placement_group", ("INFEASIBLE", info))

    def remove_placement_group(self, pg_id_hex: str) -> bool:
        with self._lock:
            info = self.placement_groups.get(pg_id_hex)
            if info is None or info.state == "REMOVED":
                return False
            prev_state = info.state
            info.state = "REMOVED"
            # kill actors scheduled into this group (reference
            # GcsPlacementGroupManager::RemovePlacementGroup cleans up
            # dependent actors)
            doomed = [aid for aid, spec in self.actor_specs.items()
                      if spec.placement_group_id is not None
                      and spec.placement_group_id.hex() == pg_id_hex]
        for aid in doomed:
            try:
                self.kill_actor(aid, no_restart=True)
            except Exception:  # noqa: BLE001 - actor already dead
                pass
        if prev_state == "CREATED":
            for idx, nid in enumerate(info.bundle_nodes):
                node = self.nodes.get(nid)
                if node is None:
                    continue
                try:
                    self._pool.get(node.address).call(
                        "nm_return_bundle", pg_id_hex=pg_id_hex,
                        bundle_index=idx)
                except Exception:  # noqa: BLE001 - node gone; nothing to return
                    pass
        self.publish("placement_group", ("REMOVED", info))
        return True

    def get_placement_group(self, pg_id_hex: str):
        with self._lock:
            return self.placement_groups.get(pg_id_hex)

    def list_placement_groups(self):
        with self._lock:
            return list(self.placement_groups.values())

    def subscribe(self, channel: str, address: Tuple[str, int],
                  token: str) -> None:
        with self._lock:
            subs = self.subscribers.setdefault(channel, [])
            if (tuple(address), token) not in subs:
                subs.append((tuple(address), token))

    def unsubscribe(self, channel: str, address: Tuple[str, int],
                    token: str) -> None:
        """Drop one (address, token) subscription (short-lived
        subscribers — `ray_tpu logs --follow` — must not keep receiving
        pushes forever; idempotent so RPC retries are safe)."""
        with self._lock:
            subs = self.subscribers.get(channel)
            if subs is not None:
                try:
                    subs.remove((tuple(address), token))
                except ValueError:
                    pass

    def publish(self, channel: str, message: Any) -> None:
        with self._lock:
            subs = list(self.subscribers.get(channel, []))
        for address, token in subs:
            try:
                self._pool.get(address).call("cw_pubsub_push", channel=channel,
                                             token=token, message=message)
            except Exception:  # noqa: BLE001
                with self._lock:
                    try:
                        self.subscribers[channel].remove((address, token))
                    except ValueError:
                        pass

    def shutdown(self) -> None:
        self._dead = True
        self.metrics_plane.stop()
        from ray_tpu_torch._private import metrics_plane as metrics_plane_lib
        metrics_plane_lib.unregister_sampler("gcs")
        self.server.stop()
        self._pool.close_all()
        if isinstance(self.store, PersistentStore):
            self.store.stop()
