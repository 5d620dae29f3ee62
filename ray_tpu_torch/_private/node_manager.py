"""Per-node manager daemon: worker pool, local scheduler, object store host.

reference parity: src/ray/raylet/ — NodeManager (node_manager.h:125) with
ClusterTaskManager/LocalTaskManager lease scheduling
(scheduling/cluster_task_manager.cc:44, local_task_manager.cc:105),
WorkerPool (worker_pool.cc:1150), placement-group bundle resources
(placement_group_resource_manager.h), and the in-raylet plasma store host
(object_manager/plasma/store_runner.h). Leases are granted asynchronously
via a callback to the requesting core worker, mirroring the reference's
RequestWorkerLease reply flow (node_manager.proto:361).
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import ownership as _ownership
from ray_tpu_torch._private import rpc as rpc_lib
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import NodeID, WorkerID, rand_bytes
from ray_tpu_torch._private.object_store import StoreServer
from ray_tpu_torch._private.scheduler import _labels_match, pick_node
from ray_tpu_torch._private.state import (NodeAffinitySchedulingStrategy, NodeInfo,
                                    NodeLabelSchedulingStrategy,
                                    PlacementGroupSchedulingStrategy,
                                    ResourceSet, TaskSpec, TaskType)
from ray_tpu_torch.util.locks import TracedLock

logger = logging.getLogger(__name__)


def pg_resource_name(resource: str, pg_id_hex: str, bundle_index: int = -1) -> str:
    """Bundle-scoped resource names (reference bundle_spec.h: e.g.
    CPU_group_0_<pgid> and CPU_group_<pgid>)."""
    if bundle_index >= 0:
        return f"{resource}_group_{bundle_index}_{pg_id_hex}"
    return f"{resource}_group_{pg_id_hex}"


def rewrite_resources_for_pg(resources: Dict[str, float], pg_id_hex: str,
                             bundle_index: int) -> Dict[str, float]:
    out = {}
    for r, v in resources.items():
        out[pg_resource_name(r, pg_id_hex, bundle_index)] = v
    # Always require a sliver of the wildcard resource so tasks can only run
    # on nodes holding a committed bundle of this group — and of the
    # *indexed* bundle resource when a bundle index was requested, so
    # zero-resource tasks/actors still pin to their bundle's node
    # (reference bundle_spec.h adds the indexed `bundle` resource too).
    out.setdefault(pg_resource_name("bundle", pg_id_hex), 0.001)
    if bundle_index >= 0:
        out.setdefault(pg_resource_name("bundle", pg_id_hex, bundle_index),
                       0.001)
    return out


@dataclass
class _WorkerHandle:
    worker_id: WorkerID
    proc: Optional[subprocess.Popen]
    address: Optional[Tuple[str, int]] = None
    runtime_env_key: str = ""
    idle_since: float = field(default_factory=time.monotonic)
    # Set while leased/executing
    lease_id: Optional[str] = None
    current_task: Optional[TaskSpec] = None
    task_started_at: float = 0.0
    is_actor: bool = False
    actor_id_hex: Optional[str] = None
    registered: bool = False
    blocked: bool = False  # released its resources while blocked in get


@dataclass
class _PendingLease:
    lease_id: str
    spec: TaskSpec
    reply_to: Tuple[str, int]    # requesting core worker's RPC address
    acquired: Optional[ResourceSet] = None
    submitted_at: float = field(default_factory=time.monotonic)
    # grant replies that failed transiently; bounded re-grants keep a
    # momentary connection blip from stranding the owner's parked
    # request forever (an owner that stays unreachable is dropped)
    grant_failures: int = 0


class NodeManager:
    def __init__(self, gcs_address: Tuple[str, int], session_dir: str,
                 resources: Optional[Dict[str, float]] = None,
                 is_head: bool = False, host: str = "127.0.0.1",
                 labels: Optional[Dict[str, str]] = None,
                 object_store_capacity: Optional[int] = None):
        self.node_id = NodeID.from_random()
        self.session_dir = session_dir
        self.gcs_address = tuple(gcs_address)
        from ray_tpu_torch._private.runtime_env import RuntimeEnvManager
        self._runtime_env_mgr = RuntimeEnvManager()
        self._pool = rpc_lib.ClientPool(timeout=60)
        self._gcs = rpc_lib.RpcClient(self.gcs_address, timeout=60)
        self._lock = TracedLock("node_manager")
        self._dead = False

        if resources is None:
            resources = {}
        resources.setdefault("CPU", float(os.cpu_count() or 1))
        resources.setdefault("memory", float(64 << 30))
        resources.setdefault("object_store_memory",
                             float(Config.object_store_capacity_bytes))
        # Accelerator autodetection (TPU chips as `TPU` resource).
        from ray_tpu_torch._private.accelerators import detect_node_accelerators
        for k, v in detect_node_accelerators().items():
            resources.setdefault(k, v)
        self.resources_total = ResourceSet(resources)
        # change-triggered resource sync (reference RaySyncer,
        # common/ray_syncer/ray_syncer.h:88 — raylets push resource
        # deltas to the GCS the moment they change over a streaming
        # channel, instead of the GCS discovering them at the next
        # poll): every add/subtract sets the dirty event the report
        # loop waits on; versioning makes stale reports droppable.
        self._resync_event = threading.Event()
        self._resource_version = 0

        class _SyncedResources(ResourceSet):
            __slots__ = ("_nm",)

            def add(rs, other):  # noqa: N805
                ResourceSet.add(rs, other)
                rs._nm._resync_event.set()

            def subtract(rs, other):  # noqa: N805
                ResourceSet.subtract(rs, other)
                rs._nm._resync_event.set()

        self.available = _SyncedResources(resources)
        self.available._nm = self

        node_store_dir = os.path.join(session_dir, self.node_id.hex()[:12])
        os.makedirs(node_store_dir, exist_ok=True)
        self.store = StoreServer(
            node_store_dir,
            object_store_capacity or Config.object_store_capacity_bytes,
            host=host)

        self.workers: Dict[str, _WorkerHandle] = {}     # worker id hex -> handle
        # worker id hex -> pre-kill flight data (span tail, rss) captured
        # by daemon-initiated kill paths while the victim still answers
        self._prekill_dumps: Dict[str, Dict[str, Any]] = {}
        # pids currently SIGSTOPped by chaos_stall_worker: keeps a rule
        # that keeps firing from stacking stalls on the same victim
        self._stalled: set = set()
        self.idle: Dict[str, List[str]] = {}            # runtime env key -> ids
        self.pending: List[_PendingLease] = []
        # lease id -> worker id hex; grant/release funnel through the
        # ownership protocol module so every NM-side lease transition
        # lands in the ring (`ray_tpu ownership`)
        self.leases = _ownership.NMLeases()
        self._starting = 0
        self._starting_by_key: Dict[str, int] = {}
        self.num_args_prefetched = 0
        self._prepared: Dict[Tuple[str, int], Dict[str, float]] = {}
        self._committed: Dict[Tuple[str, int], Tuple] = {}

        self.server = rpc_lib.RpcServer({
            "nm_ping": lambda: "pong",
            # chaos-policy pubsub lands here too (the GCS publishes to
            # subscriber addresses via this one method name)
            "cw_pubsub_push": self._on_pubsub_push,
            "nm_chaos_kill_worker": self.chaos_kill_worker,
            "nm_chaos_stall_worker": self.chaos_stall_worker,
            "nm_kill_worker_pid": self.kill_worker_pid,
            "nm_register_worker": self.register_worker,
            "nm_request_lease": self.request_lease,
            "nm_lease_request_batch": self.request_lease_batch,
            "nm_cancel_lease": self.cancel_lease,
            "nm_return_worker": self.return_worker,
            "nm_schedule_actor_creation": self.schedule_actor_creation,
            "nm_worker_blocked": self.worker_blocked,
            "nm_worker_unblocked": self.worker_unblocked,
            "nm_prepare_bundle": self.prepare_bundle,
            "nm_commit_bundle": self.commit_bundle,
            "nm_return_bundle": self.return_bundle,
            "nm_get_info": self.get_info,
            "nm_list_workers": self.list_workers,
            "nm_spans_snapshot": self.spans_snapshot,
            "nm_metrics_snapshot": self.metrics_snapshot,
            "nm_logs_snapshot": self.logs_snapshot,
            "nm_profile_worker": self.profile_worker,
            "nm_profile_workers": self.profile_workers,
            "nm_profile_collect": self.profile_collect,
            "nm_memory_snapshot": self.memory_snapshot,
            "nm_ownership_snapshot": self.ownership_snapshot,
            "nm_locks_snapshot": self.locks_snapshot,
            "nm_drain": self.drain,
        }, host=host)
        self.address = self.server.address

        from ray_tpu_torch._private import spans as _spans_lib
        _spans_lib.set_process_label(f"raylet-{self.node_id.hex()[:8]}",
                                     node_id=self.node_id.hex())
        # node-level gauges (store occupancy, worker pool, lease queue)
        # exported at metrics-harvest time (_private/metrics_plane.py)
        from ray_tpu_torch._private import metrics_plane as _metrics_plane
        _metrics_plane.register_sampler("node_manager",
                                        self._sample_metric_gauges)
        # held-alive store entries ride every metrics harvest so the
        # watchdog's leak probes can compare residency against live
        # owners' claims (memory_plane.py)
        from ray_tpu_torch._private import memory_plane as _memory_plane
        _metrics_plane.register_snapshot_extra(
            _memory_plane.STORE_DIGEST_KEY, self._store_objects_digest)
        self.info = NodeInfo(
            node_id=self.node_id, address=self.address,
            store_address=self.store.address,
            resources_total=self.resources_total.to_dict(),
            labels=labels or {}, is_head=is_head)
        self._gcs.call("register_node", info=self.info)
        self._report_thread = threading.Thread(
            target=self._resource_report_loop, daemon=True,
            name=f"nm-report-{self.node_id.hex()[:6]}")
        self._report_thread.start()
        # OOM defense (reference memory_monitor.h + worker killing
        # policies): above the usage threshold, kill the newest retriable
        # normal task's worker — its owner retries it, and the node
        # survives instead of the kernel OOM-killing the daemon.
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor
        self.memory_monitor = MemoryMonitor(
            self._kill_worker_for_memory,
            threshold=Config.memory_usage_threshold,
            period_s=Config.memory_monitor_refresh_ms / 1000.0)
        # tail worker logs -> GCS "worker_logs" channel -> drivers
        # (reference _private/log_monitor.py)
        from ray_tpu_torch._private.log_monitor import LogMonitor
        self.log_monitor = LogMonitor(
            os.path.join(self.session_dir, "logs"), self.gcs_address,
            self.node_id.hex())
        # Chaos plane (_private/chaos.py): this daemon is the kill_worker
        # actuator for rules targeting this node, and must track policy
        # updates (fetch now + follow the "chaos" pubsub channel).
        from ray_tpu_torch._private import chaos as chaos_lib
        chaos_lib.client().set_context(node_id=self.node_id.hex(),
                                       gcs_address=self.gcs_address)
        chaos_lib.client().set_kill_actuator(self.chaos_kill_worker)
        chaos_lib.client().set_stall_actuator(self.chaos_stall_worker)
        chaos_lib.fetch_policy(self._gcs.call)
        self._chaos_token = uuid.uuid4().hex
        try:
            self._gcs.call("subscribe", channel="chaos",
                           address=self.address, token=self._chaos_token)
        except Exception:  # noqa: BLE001 - chaos updates degrade to fetch
            pass

    # ---- resource sync ---------------------------------------------------

    def _resource_report_loop(self) -> None:
        while not self._dead:
            try:
                # clear BEFORE snapshotting: a change landing during the
                # report re-sets the event and re-wakes immediately
                self._resync_event.clear()
                with self._lock:
                    avail = self.available.to_dict()
                    self._resource_version += 1
                    version = self._resource_version
                resp = self._gcs.call(
                    "report_resources",
                    node_id_hex=self.node_id.hex(), available=avail,
                    version=version)
                if resp == "unknown_node" and not self._dead:
                    # the GCS restarted (or declared us dead during a
                    # blip): re-register so scheduling resumes — but
                    # never resurrect a node that is itself shutting
                    # down. Follow with a fresh report so the GCS sees
                    # true availability, not resources_total.
                    logger.warning(
                        "GCS does not know node %s — re-registering",
                        self.node_id.hex()[:12])
                    self._gcs.call("register_node", info=self.info)
                    with self._lock:
                        avail = self.available.to_dict()
                    self._gcs.call(
                        "report_resources",
                        node_id_hex=self.node_id.hex(), available=avail)
            except Exception:  # noqa: BLE001 - the loop retries every
                # period; debug level because a down GCS would repeat
                # this every report tick
                logger.debug("resource report to GCS failed",
                             exc_info=True)
            try:
                self._respill_pending()
            except Exception:  # noqa: BLE001
                logger.warning("respill round failed", exc_info=True)
            try:
                self._reap_idle_workers()
            except Exception:  # noqa: BLE001
                logger.warning("idle reap failed", exc_info=True)
            # syncer semantics: wake IMMEDIATELY when availability
            # changes (lease grant/return, worker death), else
            # heartbeat at the poll period; the short sleep after a
            # wake coalesces bursts into one report
            if self._resync_event.wait(
                    timeout=Config.resource_report_period_s):
                time.sleep(0.02)

    def _reap_idle_workers(self) -> None:
        """Kill workers idle past idle_worker_kill_timeout_s while the
        pool exceeds its floor (reference worker_pool.cc
        TryKillingIdleWorkers: kill down to the soft limit only). Each
        candidate is asked first (cw_can_exit) — a worker that OWNS
        objects someone still references must not die, or those objects
        are lost with it."""
        timeout = Config.idle_worker_kill_timeout_s
        if timeout <= 0:
            return
        floor = max(0, int(Config.idle_worker_pool_floor))
        now = time.monotonic()
        candidates: List[_WorkerHandle] = []
        with self._lock:
            n_idle = sum(len(ids) for ids in self.idle.values())
            for ids in self.idle.values():
                for wid in list(ids):
                    if n_idle - len(candidates) <= floor:
                        break
                    h = self.workers.get(wid)
                    if h is not None and h.address is not None and \
                            now - h.idle_since > timeout:
                        candidates.append(h)
        for h in candidates:
            try:
                can_exit = self._pool.get(h.address).call("cw_can_exit")
            except Exception:  # noqa: BLE001 - unreachable == already dead
                can_exit = True
            if not can_exit:
                continue
            with self._lock:
                # it may have been leased since the scan; only reap if
                # still idle (remove from idle so it can't be re-leased,
                # then let _monitor_worker -> _on_worker_death do the
                # full cleanup every other kill path uses)
                ids = self.idle.get(h.runtime_env_key, [])
                if h.worker_id.hex() not in ids:
                    continue
                ids.remove(h.worker_id.hex())
            logger.info("reaping idle worker %s", h.worker_id.hex()[:12])
            if h.proc is not None:
                try:
                    h.proc.terminate()
                except OSError:
                    pass

    def _respill_pending(self) -> None:
        """Re-route queued leases that became feasible on another node
        (reference: ClusterTaskManager::ScheduleAndDispatchTasks re-runs
        cluster scheduling for queued work each round; without this, a
        lease queued before e.g. a PG bundle committed elsewhere would
        wait forever)."""
        with self._lock:
            candidates = [pl for pl in self.pending if pl.acquired is None]
        if not candidates:
            return
        avail, totals, nodes, labels = self._cluster_view()
        dispatch_local = False
        for pl in candidates:
            strategy = pl.spec.scheduling_strategy
            if isinstance(strategy, NodeAffinitySchedulingStrategy) \
                    and not strategy.soft:
                continue  # hard affinity: must stay here
            required = self._effective_resources(pl.spec)
            chosen = pick_node(avail, required, strategy,
                               local_node_id=self.node_id.hex(),
                               totals=totals,
                               locality_hints=pl.spec.locality_hints,
                               labels=labels)
            logger.debug("respill: %s required=%s chosen=%s",
                         pl.spec.function_name, required.to_dict(),
                         chosen and chosen[:12])
            if chosen is None or chosen == self.node_id.hex() \
                    or chosen not in nodes:
                # locally feasible again (e.g. resources appeared via a
                # path with no dispatch trigger of its own): grant it
                # here rather than leaving the queue to wedge
                if chosen == self.node_id.hex():
                    dispatch_local = True
                continue
            with self._lock:
                if pl not in self.pending or pl.acquired is not None:
                    continue
                self.pending.remove(pl)
            try:
                self._pool.get(pl.reply_to).call(
                    "cw_lease_respill", task_id=pl.spec.task_id,
                    nm_address=nodes[chosen],
                    # name ourselves so the owner unparks its request
                    # slot from the RIGHT node manager (entry state may
                    # have moved on if another grant picked the task up)
                    from_address=self.address)
            except Exception:  # noqa: BLE001
                with self._lock:
                    self.pending.append(pl)
        if dispatch_local:
            self._dispatch()

    def _cluster_view(self) -> Tuple[Dict[str, Dict[str, float]],
                                     Dict[str, Dict[str, float]],
                                     Dict[str, Tuple[str, int]],
                                     Dict[str, Dict[str, str]]]:
        labels: Dict[str, Dict[str, str]] = {}
        try:
            view = self._gcs.call("get_cluster_resources")
            nodes = {}
            for n in self._gcs.call("get_all_nodes"):
                if n.alive:
                    nodes[n.node_id.hex()] = n.address
                    labels[n.node_id.hex()] = dict(n.labels)
        except Exception:  # noqa: BLE001
            view, nodes = {}, {}
        avail = {nid: v["available"] for nid, v in view.items()}
        totals = {nid: v["total"] for nid, v in view.items()}
        with self._lock:
            avail[self.node_id.hex()] = self.available.to_dict()
            totals[self.node_id.hex()] = self.resources_total.to_dict()
        nodes.setdefault(self.node_id.hex(), self.address)
        labels.setdefault(self.node_id.hex(),
                          dict(self.info.labels))
        return avail, totals, nodes, labels

    # ---- worker pool (reference worker_pool.cc) -------------------------

    def _runtime_env_key(self, spec: TaskSpec) -> str:
        """Worker-pool bucket key (reference worker_pool runtime-env-keyed
        caching): a worker started for one env must not serve tasks whose
        env_vars/working_dir/py_modules differ."""
        renv = spec.runtime_env or {}
        from ray_tpu_torch._private.runtime_env import (conda_spec, conda_uri,
                                                  container_spec,
                                                  pip_spec, pip_uri)
        pspec = pip_spec(renv)
        cspec = conda_spec(renv)
        ctr = container_spec(renv)
        return repr((sorted((renv.get("env_vars") or {}).items()),
                     renv.get("working_dir"),
                     tuple(renv.get("py_modules") or ()),
                     pip_uri(pspec) if pspec else None,
                     conda_uri(cspec) if cspec else None,
                     (ctr["image"], tuple(ctr["run_options"]))
                     if ctr else None))

    def _spawn_worker(self, runtime_env_key: str,
                      runtime_env: Optional[Dict[str, Any]]
                      ) -> Optional[_WorkerHandle]:
        if (runtime_env or {}).get("pip") or \
                (runtime_env or {}).get("conda"):
            # env setup can take minutes (pip/conda install): run the
            # whole spawn on a setup thread so the dispatch path (and
            # the lease-request RPC behind it) never blocks on it — the
            # reference keeps env setup in an async per-node agent for
            # the same reason (runtime_env_agent).
            threading.Thread(
                target=self._spawn_worker_sync,
                args=(runtime_env_key, runtime_env),
                daemon=True, name="worker-env-setup").start()
            return None
        return self._spawn_worker_sync(runtime_env_key, runtime_env)

    def _spawn_worker_sync(self, runtime_env_key: str,
                           runtime_env: Optional[Dict[str, Any]]
                           ) -> Optional[_WorkerHandle]:
        worker_id = WorkerID.from_random()
        env = dict(os.environ)
        # Make sure workers can import ray_tpu_torch regardless of cwd.
        import ray_tpu_torch
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["RAY_TPU_WORKER_ID"] = worker_id.hex()
        env["RAY_TPU_NODE_ID"] = self.node_id.hex()
        env["RAY_TPU_NODE_MANAGER"] = f"{self.address[0]}:{self.address[1]}"
        env["RAY_TPU_GCS"] = f"{self.gcs_address[0]}:{self.gcs_address[1]}"
        env["RAY_TPU_STORE"] = f"{self.store.address[0]}:{self.store.address[1]}"
        env["RAY_TPU_SESSION_DIR"] = self.session_dir
        for k, v in ((runtime_env or {}).get("env_vars") or {}).items():
            env[str(k)] = str(v)
        # working_dir/py_modules (reference _private/runtime_env/
        # working_dir.py, py_modules plugin): the worker starts in
        # working_dir with it importable, and each py_module's parent on
        # the path so `import <module>` works.
        renv = runtime_env or {}
        extra_paths = []
        if renv.get("working_dir"):
            extra_paths.append(os.path.abspath(renv["working_dir"]))
        for mod in renv.get("py_modules") or ():
            extra_paths.append(os.path.dirname(os.path.abspath(mod)))
        if renv.get("pip"):
            # cached per-URI install; only the first worker of a given
            # pip spec pays the install (reference pip.py + URI cache).
            # Failure must not leak the _starting counters (that would
            # wedge every future spawn for this env key) nor kill the
            # dispatch loop — fail the env's queued leases instead
            # (reference: runtime-env agent setup failure fails the
            # lease with RuntimeEnvSetupError).
            try:
                site = self._runtime_env_mgr.setup_pip(renv)
            except Exception as e:  # noqa: BLE001
                logger.error("runtime_env setup failed for %s: %s",
                             runtime_env_key, e)
                self._fail_env_leases(runtime_env_key, str(e))
                return None
            if site:
                extra_paths.append(site)
        python_exe = sys.executable
        if renv.get("conda"):
            # conda env (reference runtime_env/conda.py): the worker
            # runs with the materialized prefix's interpreter
            try:
                prefix = self._runtime_env_mgr.setup_conda(renv)
            except Exception as e:  # noqa: BLE001
                logger.error("runtime_env conda setup failed for %s: %s",
                             runtime_env_key, e)
                self._fail_env_leases(runtime_env_key, str(e))
                return None
            if prefix:
                env["CONDA_PREFIX"] = prefix
                env["PATH"] = (os.path.join(prefix, "bin") + os.pathsep
                               + env.get("PATH", ""))
                cand = os.path.join(prefix, "bin", "python")
                if os.path.exists(cand):
                    python_exe = cand
        if extra_paths:
            env["PYTHONPATH"] = os.pathsep.join(
                extra_paths + [env.get("PYTHONPATH", "")])
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(log_dir, f"worker-{worker_id.hex()[:12]}.log"),
                   "ab")
        cmd = [python_exe, "-m", "ray_tpu_torch._private.worker_main"]
        if renv.get("container"):
            # container env (reference runtime_env/container.py): the
            # worker command runs inside the image via the wrap hook
            try:
                cmd = self._runtime_env_mgr.wrap_container(renv, cmd,
                                                           env=env)
            except Exception as e:  # noqa: BLE001
                logger.error("runtime_env container wrap failed: %s", e)
                self._fail_env_leases(runtime_env_key, str(e))
                return None
        proc = subprocess.Popen(
            cmd, env=env, stdout=out, stderr=subprocess.STDOUT,
            cwd=(runtime_env or {}).get("working_dir") or None)
        handle = _WorkerHandle(worker_id=worker_id, proc=proc,
                               runtime_env_key=runtime_env_key)
        with self._lock:
            self.workers[worker_id.hex()] = handle
        threading.Thread(target=self._monitor_worker, args=(handle,),
                         daemon=True).start()
        return handle

    def _fail_env_leases(self, runtime_env_key: str, message: str) -> None:
        """Runtime-env setup failed: release the spawn slot and fail
        every queued lease whose env resolves to this key so callers
        see the error instead of hanging. Covers leases that ALREADY
        acquired resources (the lease that triggered the spawn holds
        its reservation) by returning them to the pool."""
        with self._lock:
            self._starting = max(0, self._starting - 1)
            self._starting_by_key[runtime_env_key] = max(
                0, self._starting_by_key.get(runtime_env_key, 1) - 1)
            doomed = [pl for pl in self.pending
                      if self._runtime_env_key(pl.spec) == runtime_env_key]
            self.pending = [pl for pl in self.pending
                            if pl not in doomed]
            for pl in doomed:
                if pl.acquired is not None:
                    self.available.add(pl.acquired)
        for pl in doomed:
            try:
                self._pool.get(pl.reply_to).call(
                    "cw_task_failed", task_id=pl.spec.task_id,
                    error_type="RUNTIME_ENV_SETUP_FAILED",
                    message=message)
            except Exception:  # noqa: BLE001 - owner gone; nothing to fail
                pass

    def _monitor_worker(self, handle: _WorkerHandle) -> None:
        proc = handle.proc
        if proc is None:
            return
        proc.wait()
        if self._dead:
            return
        self._on_worker_death(handle, f"worker process exited "
                                      f"with code {proc.returncode}")

    def _on_worker_death(self, handle: _WorkerHandle, reason: str) -> None:
        with self._lock:
            wid = handle.worker_id.hex()
            if wid not in self.workers:
                return
            del self.workers[wid]
            if not handle.registered:
                self._starting = max(0, self._starting - 1)
                key = handle.runtime_env_key
                self._starting_by_key[key] = max(
                    0, self._starting_by_key.get(key, 1) - 1)
            for ids in self.idle.values():
                if wid in ids:
                    ids.remove(wid)
            running = handle.current_task
            lease_id = handle.lease_id
            if lease_id is not None:
                self.leases.release(lease_id, event="worker_died")
            if running is not None and not handle.blocked:
                # blocked workers already released their resources
                self.available.add(self._effective_resources(running))
        # consume pre-kill flight data unconditionally: a kill of an
        # idle worker takes no postmortem, and leaving its entry (or
        # sidecar dump) behind would leak per kill under a recurring
        # chaos schedule
        from ray_tpu_torch._private import log_plane as _log_plane
        prekill = self._prekill_dumps.pop(wid, None) or {}
        if running is not None or handle.is_actor:
            # a death that loses work gets a crash postmortem (idle
            # pool churn — reaps, clean exits — stays silent); the
            # bundle id rides the error the owner raises so the user
            # can pull it (`ray_tpu logs --postmortem <id>`)
            pm_id = self._capture_postmortem(handle, reason, prekill)
            reason = f"{reason} [postmortem {pm_id}]"
        else:
            _log_plane.consume_flight_dump(
                os.path.join(self.session_dir, "logs"), wid)
        if handle.is_actor and handle.actor_id_hex:
            try:
                self._gcs.call("report_actor_death",
                               actor_id_hex=handle.actor_id_hex,
                               reason=reason, restart=True)
            except Exception:  # noqa: BLE001 - GCS down; health check sees the death
                pass
        if running is not None and not handle.is_actor:
            try:
                # lease_id rides along: with owner-side lease reuse the
                # task RUNNING at death may differ from the task the
                # lease was granted for — the owner maps lease->running.
                self._pool.get(running.owner_address).call(
                    "cw_task_failed", task_id=running.task_id,
                    error_type="WORKER_DIED", message=reason,
                    lease_id=lease_id)
            except Exception:  # noqa: BLE001 - owner gone; its tasks died with it
                pass
        self._dispatch()

    def register_worker(self, worker_id_hex: str,
                        address: Tuple[str, int]) -> Dict[str, Any]:
        with self._lock:
            handle = self.workers.get(worker_id_hex)
            if handle is None:
                raise KeyError(f"unknown worker {worker_id_hex}")
            handle.address = tuple(address)
            handle.registered = True
            handle.idle_since = time.monotonic()
            self._starting = max(0, self._starting - 1)
            key = handle.runtime_env_key
            self._starting_by_key[key] = max(
                0, self._starting_by_key.get(key, 1) - 1)
            self.idle.setdefault(key, []).append(worker_id_hex)
        self._dispatch()
        return {"node_id": self.node_id.hex()}

    def _pop_worker_locked(self, key: str) -> Optional[_WorkerHandle]:
        """Reference WorkerPool::PopWorker: reuse idle w/ same runtime env."""
        ids = self.idle.get(key, [])
        while ids:
            wid = ids.pop()
            handle = self.workers.get(wid)
            if handle is not None and handle.address is not None:
                return handle
        return None

    def _pop_worker(self, spec: TaskSpec,
                    spawn_if_needed: bool = True) -> Optional[_WorkerHandle]:
        key = self._runtime_env_key(spec)
        with self._lock:
            handle = self._pop_worker_locked(key)
            if handle is not None:
                return handle
            can_spawn = (spawn_if_needed
                         and self._starting_by_key.get(key, 0) == 0
                         and len(self.workers) + self._starting
                         < Config.max_workers_per_node)
            if can_spawn:
                self._starting += 1
                self._starting_by_key[key] = \
                    self._starting_by_key.get(key, 0) + 1
        if can_spawn:
            self._spawn_worker(key, spec.runtime_env)
        return None

    # ---- leases (reference lease protocol, node_manager.proto:361) ------

    # After this many redirects a lease request must settle somewhere: a
    # stale resource view can otherwise ping-pong a request between busy
    # node managers indefinitely (the reference caps spillbacks via the
    # lease client's budget + queueing at the selected raylet).
    LEASE_SPILL_BUDGET = 4

    def _route_lease(self, spec: TaskSpec,
                     spill_count: int) -> Optional[Tuple[str, Any]]:
        """Cluster-routing front half of request_lease. Returns
        ("spill", node_mgr_addr) | ("infeasible", message), or None when
        the request should queue locally."""
        required = self._effective_resources(spec)
        strategy = spec.scheduling_strategy
        if isinstance(strategy, NodeAffinitySchedulingStrategy) \
                and not strategy.soft \
                and strategy.node_id != self.node_id.hex():
            # Hard affinity to another node: route there; it queues or
            # rejects. Never silently run elsewhere (reference
            # node_affinity_scheduling_policy.h semantics).
            _, _, nodes, _ = self._cluster_view()
            target = nodes.get(strategy.node_id)
            if target is None:
                return ("infeasible",
                        f"hard-affinity node {strategy.node_id[:12]} is dead")
            return ("spill", target)
        avail, totals, nodes, labels = self._cluster_view()
        chosen = pick_node(avail, required, strategy,
                           local_node_id=self.node_id.hex(), totals=totals,
                           locality_hints=spec.locality_hints,
                           labels=labels)
        if isinstance(strategy, NodeAffinitySchedulingStrategy) \
                and not strategy.soft:
            chosen = self.node_id.hex()  # queue here (we are the target)
        if chosen is not None and chosen != self.node_id.hex() \
                and spill_count < self.LEASE_SPILL_BUDGET:
            return ("spill", nodes[chosen])
        if chosen is None or chosen != self.node_id.hex():
            # Nothing available right now (or out of redirect budget):
            # queue at a node whose TOTAL resources can ever run the task.
            if not required.is_subset_of(self.resources_total):
                for nid in sorted(totals):
                    if nid != self.node_id.hex() and nodes.get(nid) and \
                            required.is_subset_of(ResourceSet(totals[nid])):
                        return ("spill", nodes[nid])
                # Cluster-wide infeasible: stay pending here like the
                # reference (resources may yet appear, e.g. autoscaling);
                # the owner's get() timeout is the backstop.
        logger.debug("request_lease: %s queued locally (spill_count=%d)",
                     spec.function_name, spill_count)
        return None

    def request_lease(self, spec: TaskSpec,
                      reply_to: Tuple[str, int],
                      spill_count: int = 0) -> Tuple[str, Any]:
        """Returns ("spill", node_mgr_addr) | ("queued", lease_id) |
        ("infeasible", message)."""
        routed = self._route_lease(spec, spill_count)
        if routed is not None:
            return routed
        lease_id = rand_bytes(16).hex()
        pl = _PendingLease(lease_id=lease_id, spec=spec,
                           reply_to=tuple(reply_to))
        with self._lock:
            self.pending.append(pl)
        self._dispatch()
        return ("queued", lease_id)

    def request_lease_batch(self, specs: List[TaskSpec],
                            reply_to: Tuple[str, int],
                            spill_count: int = 0) -> List[Tuple[str, Any]]:
        """Multi-grant lease request: N specs route in one RPC, all
        locally-queued entries land under ONE lock pass and ONE dispatch
        (reference direct_task_transport pipelines RequestWorkerLease for
        the same reason — the per-request round trip is the task-path
        ceiling). Returns a reply per spec, aligned with the input:
        ("queued", lease_id) | ("spill", addr) | ("infeasible", msg).
        The owner retries spilled/infeasible entries on the singleton
        path; duplicate delivery of the whole batch (client resend after
        a send failure) just queues fresh lease ids whose extra grants
        the owner's note_grant dedup returns."""
        replies: List[Tuple[str, Any]] = []
        queued: List[_PendingLease] = []
        for spec in specs:
            routed = self._route_lease(spec, spill_count)
            if routed is not None:
                replies.append(routed)
                continue
            lease_id = rand_bytes(16).hex()
            queued.append(_PendingLease(lease_id=lease_id, spec=spec,
                                        reply_to=tuple(reply_to)))
            replies.append(("queued", lease_id))
        if queued:
            with self._lock:
                self.pending.extend(queued)
            self._dispatch()
        return replies

    def _effective_resources(self, spec: TaskSpec) -> ResourceSet:
        strategy = spec.scheduling_strategy
        if (isinstance(strategy, PlacementGroupSchedulingStrategy)
                and spec.placement_group_id is not None):
            return ResourceSet(rewrite_resources_for_pg(
                spec.resources, spec.placement_group_id.hex(),
                spec.placement_group_bundle_index))
        return spec.required_resources()

    def _dispatch(self) -> None:
        """Grant queued leases while resources + workers allow (reference
        LocalTaskManager::DispatchScheduledTasksToWorkers)."""
        granted: List[Tuple[_PendingLease, _WorkerHandle]] = []
        spawns: List[Tuple[str, Optional[Dict[str, Any]]]] = []
        with self._lock:
            remaining: List[_PendingLease] = []
            want_spawn: Dict[str, int] = {}
            # Per-pass failure memo: once a resource shape fails to
            # acquire, every later identical shape in this pass fails
            # too (resources only shrink within the loop) — keeps a
            # dispatch pass O(shapes) instead of O(pending) subset
            # checks when tens of thousands of same-shape leases queue
            # (SURVEY §6 single-node envelope: 1M queued tasks).
            failed_shapes: set = set()
            for pl in self.pending:
                # hard label constraints must hold on THIS node before a
                # queued lease may dispatch locally (the cluster-level
                # pick already respects them; local dispatch must too)
                strategy = pl.spec.scheduling_strategy
                if isinstance(strategy, NodeLabelSchedulingStrategy) \
                        and strategy.hard and not _labels_match(
                            self.info.labels, strategy.hard):
                    remaining.append(pl)
                    continue
                if pl.acquired is None:
                    required = self._effective_resources(pl.spec)
                    shape = tuple(sorted(required.to_dict().items()))
                    if shape in failed_shapes:
                        remaining.append(pl)
                        continue
                    if required.is_subset_of(self.available):
                        self.available.subtract(required)
                        pl.acquired = required
                    else:
                        failed_shapes.add(shape)
                        remaining.append(pl)
                        continue
                key = self._runtime_env_key(pl.spec)
                handle = self._pop_worker_locked(key)
                if handle is None:
                    remaining.append(pl)
                    want_spawn[key] = want_spawn.get(key, 0) + 1
                    if want_spawn[key] > self._starting_by_key.get(key, 0) \
                            and len(self.workers) + self._starting \
                            < Config.max_workers_per_node:
                        self._starting += 1
                        self._starting_by_key[key] = \
                            self._starting_by_key.get(key, 0) + 1
                        spawns.append((key, pl.spec.runtime_env))
                    continue
                handle.lease_id = pl.lease_id
                handle.current_task = pl.spec
                handle.task_started_at = time.time()
                self.leases.grant(pl.lease_id, handle.worker_id.hex())
                granted.append((pl, handle))
            self.pending = remaining
        for key, renv in spawns:
            self._spawn_worker(key, renv)
        if granted:
            self._prefetch_args([pl.spec for pl, _ in granted])
        # Group grant replies per owner: one dispatch pass over a deep
        # backlog grants many leases to the same core worker, and each
        # cw_lease_granted round trip costs ~300µs on this box — a
        # grouped cw_lease_granted_batch collapses them into one call
        # (the owner loops _on_lease_granted per element; note_grant's
        # dedup ring makes a replayed batch harmless).
        by_owner: Dict[Tuple[str, int], List[Tuple[_PendingLease,
                                                   _WorkerHandle]]] = {}
        for pl, handle in granted:
            by_owner.setdefault(pl.reply_to, []).append((pl, handle))
        for reply_to, group in by_owner.items():
            grants = [dict(lease_id=pl.lease_id, task_id=pl.spec.task_id,
                           worker_address=handle.address,
                           worker_id=handle.worker_id.hex(),
                           node_id=self.node_id.hex(),
                           nm_address=self.address)
                      for pl, handle in group]
            try:
                if len(grants) == 1:
                    self._pool.get(reply_to).call(
                        "cw_lease_granted", **grants[0])
                else:
                    self._pool.get(reply_to).call(
                        "cw_lease_granted_batch", grants=grants)
            except Exception:  # noqa: BLE001
                requeued = False
                for pl, _handle in group:
                    pl.grant_failures += 1
                    if pl.grant_failures <= 2:
                        # transient reply loss: the owner still holds a
                        # request slot parked here and would stall
                        # forever if we silently dropped the lease —
                        # reclaim the worker and re-queue the lease for
                        # a fresh grant
                        logger.warning(
                            "lease reply to %s failed (attempt %d); "
                            "re-queueing", reply_to, pl.grant_failures)
                        self.return_worker(pl.lease_id)
                        with self._lock:
                            pl.acquired = None
                            self.pending.append(pl)
                        requeued = True
                    else:
                        logger.warning(
                            "lease reply to %s failed; reclaiming",
                            reply_to)
                        self.return_worker(pl.lease_id)
                if requeued:
                    self._dispatch()

    def _prefetch_args(self, specs: List[TaskSpec]) -> None:
        """Pull the batch's remote args into the local store while the
        lease replies are in flight (reference raylet DependencyManager +
        PullManager: args land on the node before dispatch; without it
        the worker stalls pulling them serially at execution time). One
        thread per dispatch batch; the store dedups concurrent pulls of
        the same object."""
        remote_args = {}
        for spec in specs:
            for oid, (addr, size) in spec.arg_locations.items():
                if tuple(addr) != self.store.address:
                    remote_args[oid] = (tuple(addr), size)
        if not remote_args:
            return

        def pull_all() -> None:
            for oid, (addr, size) in remote_args.items():
                try:
                    self.store.pull(oid, addr, size)
                    with self._lock:
                        self.num_args_prefetched += 1
                except Exception:  # noqa: BLE001 - worker's own pull (or
                    pass  # lineage recovery) is the fallback path

        threading.Thread(target=pull_all, daemon=True,
                         name="arg-prefetch").start()

    def cancel_lease(self, lease_id: str) -> None:
        with self._lock:
            for pl in list(self.pending):
                if pl.lease_id == lease_id:
                    self.pending.remove(pl)
                    if pl.acquired is not None:
                        self.available.add(pl.acquired)
                    return
        self.return_worker(lease_id)

    def return_worker(self, lease_id: str, reuse: bool = True) -> None:
        with self._lock:
            wid = self.leases.release(lease_id)
            if wid is None:
                return
            handle = self.workers.get(wid)
            if handle is None:
                return
            if handle.current_task is not None and not handle.blocked:
                self.available.add(
                    self._effective_resources(handle.current_task))
            handle.blocked = False
            handle.current_task = None
            handle.lease_id = None
            handle.idle_since = time.monotonic()
            if reuse:
                self.idle.setdefault(handle.runtime_env_key, []).append(wid)
        if not reuse and handle.proc is not None:
            handle.proc.terminate()
        self._dispatch()

    # ---- actors ----------------------------------------------------------

    def schedule_actor_creation(self, spec: TaskSpec) -> bool:
        """Called by GCS actor scheduler. Reserves resources for actor
        lifetime and pushes the creation task to a dedicated worker."""
        required = self._effective_resources(spec)
        with self._lock:
            if not required.is_subset_of(self.available):
                return False
            self.available.subtract(required)
        deadline = time.monotonic() + Config.worker_register_timeout_s
        handle: Optional[_WorkerHandle] = None
        while handle is None and time.monotonic() < deadline:
            handle = self._pop_worker(spec)
            if handle is None:
                time.sleep(0.02)
        if handle is None:
            with self._lock:
                self.available.add(required)
            return False
        with self._lock:
            handle.is_actor = True
            handle.actor_id_hex = spec.actor_id.hex()
            handle.current_task = spec
        self._prefetch_args([spec])
        try:
            self._pool.get(handle.address).call("w_push_task", spec=spec)
            return True
        except Exception as e:  # noqa: BLE001
            self._on_worker_death(
                handle, "actor creation push failed: "
                f"{type(e).__name__}: {e}")
            return False

    def worker_blocked(self, worker_id_hex: str) -> None:
        """Worker blocked in ray.get: release its cpu-ish resources so other
        work can run (reference NotifyDirectCallTaskBlocked)."""
        with self._lock:
            handle = self.workers.get(worker_id_hex)
            if handle is not None and handle.current_task is not None \
                    and not handle.is_actor and not handle.blocked:
                handle.blocked = True
                self.available.add(self._effective_resources(
                    handle.current_task))
        self._dispatch()

    def worker_unblocked(self, worker_id_hex: str) -> None:
        with self._lock:
            handle = self.workers.get(worker_id_hex)
            if handle is not None and handle.current_task is not None \
                    and not handle.is_actor and handle.blocked:
                handle.blocked = False
                # may oversubscribe transiently; reference re-acquires
                self.available.subtract(self._effective_resources(
                    handle.current_task))

    # ---- placement group bundles (2-phase; reference
    #      placement_group_resource_manager.h) ---------------------------

    def prepare_bundle(self, pg_id_hex: str, bundle_index: int,
                       resources: Dict[str, float]) -> bool:
        required = ResourceSet(resources)
        with self._lock:
            if not required.is_subset_of(self.available):
                return False
            self.available.subtract(required)
            self._prepared[(pg_id_hex, bundle_index)] = resources
            return True

    def commit_bundle(self, pg_id_hex: str, bundle_index: int) -> bool:
        with self._lock:
            resources = self._prepared.pop((pg_id_hex, bundle_index), None)
            if resources is None:
                return False
            add: Dict[str, float] = {}
            for r, v in resources.items():
                add[pg_resource_name(r, pg_id_hex, bundle_index)] = v
                add[pg_resource_name(r, pg_id_hex)] = v
            add[pg_resource_name("bundle", pg_id_hex, bundle_index)] = 1000
            add[pg_resource_name("bundle", pg_id_hex)] = 1000
            self.resources_total.add(ResourceSet(add))
            self.available.add(ResourceSet(add))
            self._committed[(pg_id_hex, bundle_index)] = (resources, add)
        # a lease that raced ahead of this commit (pg.ready() is
        # submitted the moment placement_group() returns) sits queued
        # un-acquired: its bundle resources exist only NOW, and on an
        # otherwise-idle node no other event re-runs dispatch — without
        # this kick it wedges until the owner's get() times out
        self._dispatch()
        return True

    def return_bundle(self, pg_id_hex: str, bundle_index: int) -> None:
        with self._lock:
            resources = self._prepared.pop((pg_id_hex, bundle_index), None)
            if resources is not None:
                self.available.add(ResourceSet(resources))
                return
            entry = self._committed.pop((pg_id_hex, bundle_index), None)
            if entry is not None:
                resources, add = entry
                self.resources_total.subtract(ResourceSet(add))
                self.available.subtract(ResourceSet(add))
                self.available.add(ResourceSet(resources))

    # ---- chaos plane (_private/chaos.py) --------------------------------

    def _on_pubsub_push(self, channel: str, token: str,
                        message: Any) -> None:
        """GCS pubsub delivery into this daemon (currently only the
        chaos-policy channel subscribes with the NM's address)."""
        if channel == "chaos":
            from ray_tpu_torch._private import chaos as chaos_lib
            chaos_lib.on_policy_message(message)

    def chaos_kill_worker(self, actor_class: str = "") -> bool:
        """kill_worker actuator: SIGKILL one live local worker whose
        hosted actor class matches the glob (empty glob prefers busy
        task workers, then anything registered). Simulates a preempted
        TPU worker — death detection, task retries, and actor restarts
        proceed through the normal machinery. Returns True if a worker
        was killed."""
        import fnmatch as _fnmatch
        with self._lock:
            live = [h for h in self.workers.values()
                    if h.proc is not None and h.registered]
            if actor_class:
                pool = [h for h in live if h.is_actor
                        and h.current_task is not None
                        and _fnmatch.fnmatchcase(
                            h.current_task.function_name, actor_class)]
            else:
                pool = sorted(live, key=lambda h: not bool(h.current_task))
            victim = pool[0] if pool else None
        if victim is None:
            return False
        logger.warning("chaos: killing worker %s (%s)",
                       victim.worker_id.hex()[:12],
                       actor_class or "any")
        # the victim still answers: grab its span tail for the
        # postmortem before the SIGKILL destroys it
        self._capture_prekill(victim)
        try:
            victim.proc.kill()
        except OSError:
            return False
        return True

    def chaos_stall_worker(self, actor_class: str = "",
                           duration_ms: float = 0.0) -> bool:
        """stall_worker actuator: SIGSTOP one live local worker whose
        hosted actor class matches the glob (empty glob prefers busy
        task workers). Freezes EVERY thread — the exact signature of a
        hung XLA collective: the main thread stops making progress AND
        the heartbeat sidecar stops beating, so the supervisor's
        staleness check (train/heartbeat.py) is the only signal left.
        After duration_ms a daemon timer SIGCONTs the victim (stray
        resume: by then the supervisor has usually SIGKILLed it —
        tolerated via the OSError guard); duration_ms=0 stalls until
        something kills the process. Returns True if a worker was
        stalled."""
        import fnmatch as _fnmatch
        import signal as _signal
        with self._lock:
            live = [h for h in self.workers.values()
                    if h.proc is not None and h.registered
                    and h.proc.pid not in self._stalled]
            if actor_class:
                pool = [h for h in live if h.is_actor
                        and h.current_task is not None
                        and _fnmatch.fnmatchcase(
                            h.current_task.function_name, actor_class)]
            else:
                pool = sorted(live, key=lambda h: not bool(h.current_task))
            victim = pool[0] if pool else None
            if victim is not None:
                self._stalled.add(victim.proc.pid)
        if victim is None:
            return False
        pid = victim.proc.pid
        logger.warning("chaos: stalling worker %s pid=%d for %s",
                       victim.worker_id.hex()[:12], pid,
                       f"{duration_ms:.0f}ms" if duration_ms > 0
                       else "ever (until killed)")
        try:
            os.kill(pid, _signal.SIGSTOP)
        except OSError:
            with self._lock:
                self._stalled.discard(pid)
            return False
        if duration_ms > 0:
            def _resume() -> None:
                time.sleep(duration_ms / 1000.0)
                with self._lock:
                    self._stalled.discard(pid)
                try:
                    os.kill(pid, _signal.SIGCONT)
                except OSError:
                    pass  # victim was killed while stopped
            threading.Thread(target=_resume, daemon=True,
                             name=f"chaos-stall-resume-{pid}").start()
        return True

    def kill_worker_pid(self, pid: int, reason: str = "") -> bool:
        """SIGKILL one local worker by OS pid. The wedge-recovery
        actuator (train/heartbeat.py hard_kill_ranks): a SIGSTOPped
        worker cannot run `cw_kill_self` — only an outside SIGKILL,
        which works on stopped processes, removes it. Returns True when
        the pid named a live registered worker and the kill landed."""
        with self._lock:
            victim = next((h for h in self.workers.values()
                           if h.proc is not None and h.proc.pid == pid),
                          None)
        if victim is None:
            return False
        logger.warning("killing worker %s pid=%d (%s)",
                       victim.worker_id.hex()[:12], pid,
                       reason or "requested by pid")
        # 1s pull timeout inside tolerates a stopped victim: the span
        # pull just times out and the postmortem ships without it
        self._capture_prekill(victim)
        try:
            victim.proc.kill()
        except OSError:
            return False
        with self._lock:
            self._stalled.discard(pid)
        return True

    # ---- misc ------------------------------------------------------------

    def get_info(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "node_id": self.node_id.hex(),
                "address": self.address,
                "store_address": self.store.address,
                "resources_total": self.resources_total.to_dict(),
                "available": self.available.to_dict(),
                "num_workers": len(self.workers),
                "num_pending_leases": len(self.pending),
                # resource shape per unplaced lease: the autoscaler's
                # demand scheduler bin-packs these into candidate node
                # types (reference resource_demand_scheduler.py)
                "pending_resource_shapes": [
                    dict(pl.spec.resources) if isinstance(
                        pl.spec.resources, dict)
                    else pl.spec.resources.to_dict()
                    for pl in self.pending if pl.acquired is None],
                "num_args_prefetched": self.num_args_prefetched,
            }

    def _kill_worker_for_memory(self) -> bool:
        """Retriable-FIFO policy (worker_killing_policy_retriable_fifo.h):
        prefer the newest-started retriable NORMAL task; fall back to the
        newest actor. Returns True when something was killed."""
        with self._lock:
            busy = [h for h in self.workers.values()
                    if h.current_task is not None and h.proc is not None]
            normal = [h for h in busy if not h.is_actor
                      and h.current_task.max_retries != 0]
            pool = normal or [h for h in busy if h.is_actor]
            if not pool:
                return False
            victim = max(pool, key=lambda h: h.task_started_at)
        fn = victim.current_task.function_name \
            if victim.current_task else "?"
        logger.warning(
            "memory pressure: killing worker %s running %s",
            victim.worker_id.hex()[:12], fn)
        self._capture_prekill(victim)
        try:
            victim.proc.kill()
        except OSError:
            return False
        # record AFTER the successful kill, off-thread, on a DEDICATED
        # short-timeout connection: the shared GCS client serializes
        # calls, so a slow control plane here would otherwise stall the
        # resource-report heartbeat and get the node marked dead
        def _oom_event() -> None:
            from ray_tpu_torch._private import rpc as rpc_lib
            from ray_tpu_torch._private.events import emit_via
            client = rpc_lib.RpcClient(self.gcs_address, timeout=5)
            try:
                emit_via(client.call, "node_manager", "OOM_KILL",
                         f"killed worker running {fn} under memory "
                         "pressure", severity="WARNING",
                         node_id=self.node_id.hex(),
                         worker_id=victim.worker_id.hex())
            finally:
                client.close()

        threading.Thread(target=_oom_event, daemon=True,
                         name="oom-event").start()
        return True

    def profile_worker(self, worker_id_hex: str,
                       timeout: float = 3.0) -> Dict[str, Any]:
        """Live stack dump of one worker process (reference: dashboard
        reporter module's py-spy stack dumps,
        dashboard/modules/reporter/profile_manager.py:11-19). Workers
        register faulthandler on SIGUSR1 (worker_main.py): the signal
        makes the worker append all-thread tracebacks to its log; this
        returns the bytes the dump added."""
        import signal as _signal
        with self._lock:
            handle = self.workers.get(worker_id_hex)
        if handle is None or handle.proc is None:
            raise KeyError(f"no live worker {worker_id_hex[:12]} "
                           f"on this node")
        log_path = os.path.join(
            self.session_dir, "logs",
            f"worker-{worker_id_hex[:12]}.log")
        before = os.path.getsize(log_path) \
            if os.path.exists(log_path) else 0
        os.kill(handle.proc.pid, _signal.SIGUSR1)
        deadline = time.monotonic() + timeout
        stack = ""
        while time.monotonic() < deadline:
            time.sleep(0.1)
            if os.path.exists(log_path) and \
                    os.path.getsize(log_path) > before:
                time.sleep(0.2)  # let the full dump flush
                with open(log_path, "rb") as f:
                    f.seek(before)
                    stack = f.read().decode(errors="replace")
                break
        return {"worker_id": worker_id_hex,
                "pid": handle.proc.pid,
                "node_id": self.node_id.hex(),
                "stack": stack}

    def profile_workers(self, timeout: float = 3.0) -> Dict[str, Any]:
        """Batched `ray stack`: dump EVERY live worker on this node in
        one RPC — the signals go out together and the log-tail waits
        run on parallel threads, so the reply lands in ~one worker's
        dump time instead of num_workers serial round trips."""
        with self._lock:
            worker_ids = [wid for wid, h in self.workers.items()
                          if h.proc is not None]
        dumps: List[Dict[str, Any]] = []
        lock = threading.Lock()

        def _one(wid: str) -> None:
            try:
                d = self.profile_worker(wid, timeout=timeout)
            except Exception as e:  # noqa: BLE001 - worker died mid-dump
                d = {"worker_id": wid, "node_id": self.node_id.hex(),
                     "pid": None, "stack": "", "error": str(e)}
            with lock:
                dumps.append(d)

        threads = [threading.Thread(target=_one, args=(wid,),
                                    daemon=True) for wid in worker_ids]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout + 2.0
        for t in threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        return {"node_id": self.node_id.hex(), "dumps": dumps}

    PROFILE_WORKER_GRACE_S = 5.0

    def profile_collect(self, duration_s: float = 5.0, hz: float = 100.0,
                        device: bool = False) -> Dict[str, Any]:
        """Profiling-plane gather for this node: sample the daemon's own
        process (the store server lives here too) AND every registered
        worker CONCURRENTLY for the same window — the workers'
        cw_profile_collect calls block for duration_s, so the daemon's
        own session runs on this handler thread in parallel with the
        fan-out. Device mode skips the daemon (no jax here) and asks
        workers for xplane traces instead."""
        from ray_tpu_torch._private import profiler as profiler_lib
        from ray_tpu_torch._private import spans as spans_lib
        with self._lock:
            worker_addrs = [h.address for h in self.workers.values()
                            if h.registered and h.address is not None]
        kwargs = {"duration_s": duration_s, "hz": hz, "device": device}
        own_box: List[Optional[Dict[str, Any]]] = [None]

        def _own() -> None:
            try:
                own_box[0] = profiler_lib.collect_local(duration_s, hz)
            except Exception:  # noqa: BLE001 - daemon profile is a
                pass           # bonus, not a reason to fail the node

        own_thread = None
        if not device:
            own_thread = threading.Thread(target=_own, daemon=True,
                                          name="nm-profile-own")
            own_thread.start()
        grace = self.PROFILE_WORKER_GRACE_S + (
            profiler_lib.device_export_s(duration_s) if device else 0.0)
        pulled = spans_lib.pull_snapshots(
            worker_addrs, "cw_profile_collect",
            timeout=duration_s + grace, call_kwargs=kwargs)
        if own_thread is not None:
            own_thread.join(timeout=duration_s + 5.0)
        profiles = [p for p in (own_box[0],) if p is not None]
        profiles.extend(snap for _a, snap, _t0, _t1 in pulled)
        # worker_addrs lets the GCS's concurrent direct pull dedupe by
        # proc uid without transferring twice being a correctness issue
        # (the collect singleflight already shares one session)
        return {"node_id": self.node_id.hex(), "profiles": profiles,
                "worker_addrs": [list(a) for a, _r, _t0, _t1 in pulled]}

    MEMORY_WORKER_TIMEOUT_S = 3.0

    def memory_snapshot(self, max_objects: Optional[int] = None
                        ) -> Dict[str, Any]:
        """Memory-plane gather for this node: the store's residency
        table plus every registered worker's reference-table snapshot,
        one RPC hop below the GCS `memory_collect` fan-out
        (memory_plane.py builds the cluster object table from these)."""
        from ray_tpu_torch._private import spans as spans_lib
        with self._lock:
            worker_addrs = [h.address for h in self.workers.values()
                            if h.registered and h.address is not None]
        pulled = spans_lib.pull_snapshots(
            worker_addrs, "cw_memory_snapshot",
            timeout=self.MEMORY_WORKER_TIMEOUT_S,
            call_kwargs={"max_objects": max_objects}
            if max_objects is not None else None)
        return {"node_id": self.node_id.hex(),
                "store_addr": list(self.store.address),
                "store": self.store.list_objects(),
                "worker_snaps": [snap for _a, snap, _t0, _t1 in pulled],
                "worker_addrs": [list(a) for a, _r, _t0, _t1 in pulled]}

    OWNERSHIP_WORKER_TIMEOUT_S = 3.0

    def ownership_snapshot(self, object_id: Optional[str] = None,
                           limit: int = 200) -> Dict[str, Any]:
        """Ownership-protocol gather for this node: the daemon's own
        transition ring (NM lease grants + store reader leases live in
        this process), the NM's held leases, the store's leased/pinned
        entries, plus every registered worker's cw_ownership_snapshot —
        one RPC hop below the GCS `ownership_collect` fan-out."""
        from ray_tpu_torch._private import spans as spans_lib
        ring_snap = _ownership.ring().snapshot(
            key_prefix=object_id or None, limit=limit)
        with self._lock:
            worker_addrs = [h.address for h in self.workers.values()
                            if h.registered and h.address is not None]
            nm_leases = {lid: wid[:12] for lid, wid in
                         self.leases.items()}
        store_held = [e for e in self.store.list_objects()
                      if (e.get("pinned") or 0) > 0
                      or (e.get("leases") or 0) > 0]
        if object_id:
            store_held = [e for e in store_held
                          if e["object_id"].startswith(object_id)]
        kwargs = {"limit": limit}
        if object_id is not None:
            kwargs["object_id"] = object_id
        pulled = spans_lib.pull_snapshots(
            worker_addrs, "cw_ownership_snapshot",
            timeout=self.OWNERSHIP_WORKER_TIMEOUT_S, call_kwargs=kwargs)
        return {"proc_uid": spans_lib.PROC_UID,
                "node_id": self.node_id.hex(),
                "store_addr": list(self.store.address),
                "nm_leases": nm_leases,
                "store_held": store_held,
                "transitions": ring_snap["transitions"],
                "anomalies": ring_snap["anomalies"],
                "worker_snaps": [snap for _a, snap, _t0, _t1 in pulled],
                "worker_addrs": [list(a) for a, _r, _t0, _t1 in pulled]}

    def _store_objects_digest(self) -> Dict[str, Any]:
        """Held-alive (pinned/leased) store entries for the harvest's
        leak probes (memory_plane.store_digest). `registered_workers`
        lets the probe verify WORKER-granularity coverage: one stalled
        worker missing from the harvest must disable this node's
        absence-based checks for the round, not read as a dead owner."""
        from ray_tpu_torch._private import memory_plane as memory_plane_lib
        entries, truncated = memory_plane_lib.store_digest(
            self.store.list_objects(),
            cap=Config.memory_digest_max_objects)
        with self._lock:
            registered = sum(1 for h in self.workers.values()
                             if h.registered and h.address is not None)
        return {"entries": entries, "truncated": truncated,
                "registered_workers": registered,
                "node_id": self.node_id.hex()}

    SPANS_WORKER_TIMEOUT_S = 3.0

    def spans_snapshot(self) -> Dict[str, Any]:
        """Flight-recorder gather for this node: the daemon's own span
        ring (which includes the store server — same process) plus every
        registered worker's, each annotated with the RPC-midpoint
        estimate of worker_wall_clock - nm_wall_clock. The reply's
        top-level wall_time lets the GCS chain its own offset estimate
        on top (see gcs.spans_collect)."""
        from ray_tpu_torch._private import spans as spans_lib
        # stamp the reply's wall clock BEFORE the worker gather: the GCS
        # estimates this node's clock offset as wall_time - rpc_midpoint,
        # and a slow gather (one hung worker burns its full timeout)
        # stamped at the end would skew every snapshot from this node by
        # half the gather duration
        reply_wall = time.time()
        own = spans_lib.snapshot()
        own["clock_offset_s"] = 0.0
        with self._lock:
            worker_addrs = [h.address for h in self.workers.values()
                            if h.registered and h.address is not None]
        pulled = spans_lib.pull_snapshots(
            worker_addrs, "cw_spans_snapshot",
            timeout=self.SPANS_WORKER_TIMEOUT_S)
        snapshots: List[Dict[str, Any]] = [own]
        for _addr, snap, t0, t1 in pulled:
            snap["clock_offset_s"] = snap["wall_time"] - (t0 + t1) / 2.0
            snapshots.append(snap)
        # worker_addrs lets the GCS skip its direct-subscriber pull for
        # workers this reply already covers (they also subscribe to
        # pubsub, so without this every worker ring would ship twice).
        # Only successfully-pulled workers count: one the NM couldn't
        # reach may still be reachable from the GCS directly.
        return {"wall_time": reply_wall, "snapshots": snapshots,
                "worker_addrs": [list(a) for a, _r, _t0, _t1 in pulled]}

    def _sample_metric_gauges(self) -> None:
        """Node-level gauges for the metrics harvest: object-store
        occupancy (incl. eviction-exempt pinned/leased bytes — the
        watchdog's store probes), worker-pool size, and queued leases.
        The gauge names match the Grafana panel exprs shipped by
        dashboard/metrics.py."""
        from ray_tpu_torch.util.metrics import Gauge, get_or_create
        stats = self.store.stats()
        for name, desc, value in (
                ("ray_tpu_object_store_used_bytes",
                 "bytes resident in this node's object store",
                 stats["used"]),
                ("ray_tpu_object_store_capacity_bytes",
                 "this node's object store capacity",
                 stats["capacity"]),
                ("ray_tpu_object_store_pinned_bytes",
                 "eviction-exempt bytes (owner pins + reader leases)",
                 stats["pinned_bytes"]),
                ("ray_tpu_object_store_objects",
                 "objects resident in this node's store",
                 stats["num_objects"])):
            get_or_create(Gauge, name, description=desc).set(float(value))
        with self._lock:
            num_workers = len(self.workers)
            pending = len(self.pending)
        get_or_create(
            Gauge, "ray_tpu_num_workers",
            description="worker processes on this node"
        ).set(float(num_workers))
        get_or_create(
            Gauge, "ray_tpu_pending_leases",
            description="lease requests queued at this node manager"
        ).set(float(pending))

    METRICS_WORKER_TIMEOUT_S = 3.0

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Metrics-plane gather for this node: the daemon's own registry
        snapshot plus every registered worker's, one RPC hop below the
        GCS fan-out (structure mirrors spans_snapshot; metrics carry
        their own wall_time so no clock-offset chaining is needed)."""
        from ray_tpu_torch._private import metrics_plane as _metrics_plane
        from ray_tpu_torch._private import spans as spans_lib
        with self._lock:
            worker_addrs = [h.address for h in self.workers.values()
                            if h.registered and h.address is not None]
        pulled = spans_lib.pull_snapshots(
            worker_addrs, "cw_metrics_snapshot",
            timeout=self.METRICS_WORKER_TIMEOUT_S)
        snapshots = [_metrics_plane.snapshot_process()]
        snapshots.extend(snap for _a, snap, _t0, _t1 in pulled)
        # worker_addrs lets the GCS skip its direct-subscriber pull for
        # workers this reply already covers (only successfully-pulled
        # ones: a worker the NM missed may answer the GCS directly)
        return {"snapshots": snapshots,
                "worker_addrs": [list(a) for a, _r, _t0, _t1 in pulled]}

    def locks_snapshot(self) -> Dict[str, Any]:
        """Lockdep-plane gather for this node: the daemon's own traced
        locks plus every registered worker's, one hop below the GCS
        `locks_collect` fan-out (structure mirrors metrics_snapshot)."""
        from ray_tpu_torch._private import spans as spans_lib
        from ray_tpu_torch.util import locks as locks_lib
        with self._lock:
            worker_addrs = [h.address for h in self.workers.values()
                            if h.registered and h.address is not None]
        pulled = spans_lib.pull_snapshots(
            worker_addrs, "cw_locks_snapshot",
            timeout=self.METRICS_WORKER_TIMEOUT_S)
        snapshots = [locks_lib.snapshot()]
        snapshots.extend(snap for _a, snap, _t0, _t1 in pulled)
        return {"snapshots": snapshots,
                "worker_addrs": [list(a) for a, _r, _t0, _t1 in pulled]}

    def logs_snapshot(self, filters: Optional[Dict[str, Any]] = None,
                      tail: int = 500) -> Dict[str, Any]:
        """Debug-plane gather for this node: a fresh scan + the filtered
        tail index of every worker log file, one RPC hop below the GCS
        `logs_query` fan-out. Filtering runs HERE so the fan-out ships
        matching records, not every node's whole tail. worker_addrs lets
        the GCS skip its direct-subscriber pull for workers this node's
        files already cover."""
        try:
            self.log_monitor.scan_now()
        except Exception:  # noqa: BLE001 - index may lag one poll tick
            pass
        records = self.log_monitor.query(filters, tail=tail)
        with self._lock:
            worker_addrs = [h.address for h in self.workers.values()
                            if h.registered and h.address is not None]
        return {"node_id": self.node_id.hex(),
                "records": records,
                "worker_addrs": [list(a) for a in worker_addrs]}

    # ---- crash postmortems (debug plane; see _private/log_plane.py) -----

    def _capture_prekill(self, handle: _WorkerHandle) -> None:
        """Daemon-initiated kill paths call this while the victim still
        answers RPCs: pull its span-ring tail + rss so the postmortem
        can include the flight data a SIGKILL would otherwise destroy."""
        out: Dict[str, Any] = {}
        try:
            from ray_tpu_torch._private import spans as spans_lib
            got = spans_lib.pull_snapshot(
                handle.address, "cw_spans_snapshot", timeout=1.0)
            if got is not None:
                k = Config.postmortem_span_tail
                out["span_tail"] = [list(r) for r in
                                    got[0].get("spans", [])[-k:]]
        except Exception:  # noqa: BLE001 - victim already unresponsive
            pass
        try:
            from ray_tpu_torch._private.log_plane import read_rss_bytes
            if handle.proc is not None:
                out["rss_bytes"] = read_rss_bytes(handle.proc.pid)
        except Exception:  # noqa: BLE001 - /proc gone; rss is optional in the bundle
            pass
        self._prekill_dumps[handle.worker_id.hex()] = out

    def _capture_postmortem(self, handle: _WorkerHandle, reason: str,
                            prekill: Optional[Dict[str, Any]] = None
                            ) -> str:
        """Bundle a dead worker's black box: last log lines (after a
        final synchronous scan so lines written just before death are
        indexed), span-ring tail (from the daemon's pre-kill pull or
        the worker's own flight dump), and node gauges. Ships to the
        GCS's bounded postmortem ring off-thread on a dedicated client
        (the shared GCS client serializes calls; a slow control plane
        must not stall worker-death handling)."""
        from ray_tpu_torch._private import log_plane
        pm_id = f"pm-{uuid.uuid4().hex[:12]}"
        wid = handle.worker_id.hex()
        prekill = prekill or self._prekill_dumps.pop(wid, None) or {}
        log_dir = os.path.join(self.session_dir, "logs")
        flight = log_plane.consume_flight_dump(log_dir, wid) or {}
        log_tail: List[Dict[str, Any]] = []
        try:
            self.log_monitor.scan_now()
            log_tail = self.log_monitor.tail_records(
                f"worker-{wid[:12]}", Config.postmortem_log_lines)
        except Exception:  # noqa: BLE001 - scan failed; flight-dump fallback below
            pass
        if not log_tail:
            log_tail = flight.get("log_tail") or []
        stats: Dict[str, Any] = {}
        try:
            stats = self.store.stats()
        except Exception:  # noqa: BLE001 - store gone; gauges are optional
            pass
        with self._lock:
            num_workers = len(self.workers)
        bundle = {
            "postmortem_id": pm_id,
            "kind": "worker_death",
            "worker_id": wid,
            "node_id": self.node_id.hex(),
            "is_actor": handle.is_actor,
            "actor_id": handle.actor_id_hex,
            "task": (handle.current_task.function_name
                     if handle.current_task is not None else None),
            "reason": reason,
            "flight_reason": flight.get("reason"),
            "ts": time.time(),
            "log_tail": log_tail,
            "span_tail": (prekill.get("span_tail")
                          or flight.get("span_tail") or []),
            "gauges": {
                "rss_bytes": (prekill.get("rss_bytes")
                              or flight.get("rss_bytes")),
                "store_used_bytes": stats.get("used"),
                "store_capacity_bytes": stats.get("capacity"),
                "store_pinned_bytes": stats.get("pinned_bytes"),
                "num_workers": num_workers,
            },
        }

        def _send() -> None:
            client = rpc_lib.RpcClient(self.gcs_address, timeout=10)
            try:
                client.call("postmortem_report", bundle=bundle)
            except Exception:  # noqa: BLE001 - GCS away; bundle lost
                logger.debug("postmortem report failed", exc_info=True)
            finally:
                client.close()

        threading.Thread(target=_send, daemon=True,
                         name="postmortem-report").start()
        return pm_id

    def list_workers(self) -> List[Dict[str, Any]]:
        """Worker-level metadata for the state API (`ray list workers`)."""
        with self._lock:
            return [{
                "worker_id": wid,
                "node_id": self.node_id.hex(),
                "pid": h.proc.pid if h.proc is not None else None,
                "is_actor": h.is_actor,
                "actor_id": h.actor_id_hex,
                "idle": h.current_task is None,
                "current_task": (h.current_task.function_name
                                 if h.current_task is not None else None),
            } for wid, h in self.workers.items()]

    def drain(self) -> None:
        self.shutdown()

    def shutdown(self) -> None:
        if self._dead:
            return
        self._dead = True
        from ray_tpu_torch._private import memory_plane as _memory_plane
        from ray_tpu_torch._private import metrics_plane as _metrics_plane
        _metrics_plane.unregister_sampler("node_manager")
        _metrics_plane.unregister_snapshot_extra(
            _memory_plane.STORE_DIGEST_KEY)
        try:
            self.memory_monitor.stop()
        except AttributeError:
            pass
        try:
            self.log_monitor.stop()
        except AttributeError:
            pass
        with self._lock:
            workers = list(self.workers.values())
        for handle in workers:
            if handle.proc is not None:
                try:
                    handle.proc.terminate()
                except OSError:
                    pass
        for handle in workers:
            if handle.proc is not None:
                try:
                    handle.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    handle.proc.kill()
        try:
            self._gcs.call("unregister_node", node_id_hex=self.node_id.hex())
        except Exception:  # noqa: BLE001 - GCS gone; health check expires us
            pass
        self.store.shutdown()
        self.server.stop()
        self._pool.close_all()
        self._gcs.close()
