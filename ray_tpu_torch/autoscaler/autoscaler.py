"""StandardAutoscaler + NodeProvider implementations.

reference parity: autoscaler/_private/autoscaler.py (StandardAutoscaler:
poll load → launch/terminate through a provider), node_provider.py (the
provider ABC), fake_multi_node/node_provider.py ("nodes" are local
processes). Demand here = queued worker leases reported by node
managers; idle = a worker node with no busy workers and no queue for
idle_timeout_s.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class ProviderNode:
    provider_id: str
    node_id_hex: Optional[str] = None    # filled once registered in GCS
    created_at: float = field(default_factory=time.time)
    handle: Any = None                   # provider-private


class NodeProvider:
    """reference node_provider.py ABC, reduced to the scaling contract."""

    def create_node(self, resources: Dict[str, float]) -> ProviderNode:
        raise NotImplementedError

    def terminate_node(self, node: ProviderNode) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[ProviderNode]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Nodes are `node_main` subprocesses joining the GCS (the fake-
    multinode pattern: scale tests without a cloud)."""

    def __init__(self, gcs_address: str):
        self.gcs_address = gcs_address
        self._nodes: Dict[str, ProviderNode] = {}

    def create_node(self, resources: Dict[str, float]) -> ProviderNode:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.node_main",
             "--gcs-address", self.gcs_address,
             "--resources", json.dumps(resources)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        line = proc.stdout.readline()
        info = json.loads(line) if line else {}
        node = ProviderNode(provider_id=uuid.uuid4().hex[:8],
                            node_id_hex=info.get("node_id"), handle=proc)
        self._nodes[node.provider_id] = node
        return node

    def terminate_node(self, node: ProviderNode) -> None:
        self._nodes.pop(node.provider_id, None)
        proc: subprocess.Popen = node.handle
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()

    def non_terminated_nodes(self) -> List[ProviderNode]:
        return [n for n in self._nodes.values()
                if n.handle.poll() is None]


class FakeMultiNodeProvider(NodeProvider):
    """Instant in-memory nodes (reference
    autoscaler/_private/fake_multi_node/node_provider.py — the testable
    fake behind AutoscalingCluster): no processes, no GCS; scaling
    logic and bin-packing are testable at zero spawn latency. Each
    fake node records the resource shape it was launched with."""

    def __init__(self):
        self._nodes: Dict[str, ProviderNode] = {}
        self.created_shapes: List[Dict[str, float]] = []

    def create_node(self, resources: Dict[str, float]) -> ProviderNode:
        node = ProviderNode(provider_id=uuid.uuid4().hex[:8],
                            node_id_hex=uuid.uuid4().hex,
                            handle=dict(resources))
        self._nodes[node.provider_id] = node
        self.created_shapes.append(dict(resources))
        return node

    def terminate_node(self, node: ProviderNode) -> None:
        self._nodes.pop(node.provider_id, None)

    def non_terminated_nodes(self) -> List[ProviderNode]:
        return list(self._nodes.values())


class SliceBackend:
    """Host-materialization hook for GKETPUNodeProvider (the seam the
    reference gets from batching_node_provider.py:54 — the provider
    asks the platform for hosts; how they appear is pluggable/testable).
    create_hosts returns one dict per host: at least
    {"host_id": ..., "node_id_hex": ... or None, "resources": {...}}."""

    def create_hosts(self, pool: str,
                     host_resources: List[Dict[str, float]]
                     ) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def delete_hosts(self, pool: str) -> None:
        raise NotImplementedError


class FakeSliceBackend(SliceBackend):
    """Instant in-memory slice hosts (the FakeMultiNode pattern): each
    host records the resource shape it registered with, so autoscaler
    tests can drive PG demand -> slice scale-up without GKE."""

    def __init__(self):
        self.hosts_by_pool: Dict[str, List[Dict[str, Any]]] = {}

    def create_hosts(self, pool, host_resources):
        hosts = [{"host_id": f"{pool}-host{i}",
                  "node_id_hex": uuid.uuid4().hex,
                  "resources": dict(res)}
                 for i, res in enumerate(host_resources)]
        self.hosts_by_pool[pool] = hosts
        return hosts

    def delete_hosts(self, pool):
        self.hosts_by_pool.pop(pool, None)


class GKESliceBackend(SliceBackend):
    """gcloud node-pool backend: one pool = one TPU slice; GKE boots
    the hosts, which join the cluster out of band (their node ids
    appear in the GCS once `ray start` runs on them)."""

    def __init__(self, cluster: str, zone: str, machine_type: str,
                 topology_for):
        self.cluster = cluster
        self.zone = zone
        self.machine_type = machine_type
        self._topology_for = topology_for

    def _run(self, args: List[str]) -> str:
        proc = subprocess.run(["gcloud", *args], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"gcloud {' '.join(args[:3])}... failed: "
                f"{proc.stderr[-500:]}")
        return proc.stdout

    def create_hosts(self, pool, host_resources):
        chips = int(sum(r.get("TPU", 0) for r in host_resources))
        self._run([
            "container", "node-pools", "create", pool,
            f"--cluster={self.cluster}", f"--zone={self.zone}",
            f"--num-nodes={len(host_resources)}",
            f"--machine-type={self.machine_type}",
            f"--tpu-topology={self._topology_for(chips)}",
        ])
        return [{"host_id": f"{pool}-host{i}", "node_id_hex": None,
                 "resources": dict(res)}
                for i, res in enumerate(host_resources)]

    def delete_hosts(self, pool):
        self._run([
            "container", "node-pools", "delete", pool,
            f"--cluster={self.cluster}", f"--zone={self.zone}",
            "--quiet"])


class GKETPUNodeProvider(NodeProvider):
    """GKE TPU node-pool provider: one provider "node" = one TPU pod
    SLICE (a node pool with `tpu-topology`), materialized as one host
    per TPU VM. Follows the reference provider contract
    (node_provider.py) + the TPU accelerator manager's pod-slice
    resource naming (accelerators/tpu.py:335-398): every host carries
    {"TPU": <chips/host>, "<pool>": 1}, and host 0 additionally
    carries {"TPU-<type>-head": 1} so a gang's head actor (the jax
    coordinator) lands exactly once per slice.

    `backend` is the host-materialization seam: GKESliceBackend runs
    gcloud (production); FakeSliceBackend materializes instant hosts
    (the fake-multinode test ladder, reference
    batching_node_provider.py:54 pattern).
    """

    CHIPS_PER_HOST = 4  # v5p TPU-VM hosts

    def __init__(self, cluster: str = "", zone: str = "",
                 accelerator_type: str = "v5p-8",
                 node_pool_prefix: str = "ray-tpu",
                 backend: Optional[SliceBackend] = None):
        self.cluster = cluster
        self.zone = zone
        self.accelerator_type = accelerator_type
        self.node_pool_prefix = node_pool_prefix
        self.backend = backend or GKESliceBackend(
            cluster, zone, "ct5p-hightpu-4t", self._topology_for)
        self._nodes: Dict[str, ProviderNode] = {}

    # TensorCores per chip by TPU generation: the accelerator-type
    # suffix counts CORES for v2-v5p (so "v5p-16" is 8 chips) but CHIPS
    # for the single-core-per-chip generations (v5e/v5litepod, v6e).
    # Sizing pools off the raw suffix doubled every v5p node pool and
    # its --tpu-topology (ADVICE r5).
    CORES_PER_CHIP = {"v2": 2, "v3": 2, "v4": 2, "v5p": 2,
                      "v5e": 1, "v5litepod": 1, "v6e": 1}

    @property
    def slice_chips(self) -> int:
        try:
            gen, suffix = self.accelerator_type.rsplit("-", 1)
            n = int(suffix)
        except (IndexError, ValueError):
            return self.CHIPS_PER_HOST
        return max(1, n // self.CORES_PER_CHIP.get(gen.lower(), 1))

    def _host_resources(self, pool: str) -> List[Dict[str, float]]:
        n_hosts = max(1, self.slice_chips // self.CHIPS_PER_HOST)
        out = []
        for i in range(n_hosts):
            res: Dict[str, float] = {
                "TPU": float(min(self.CHIPS_PER_HOST, self.slice_chips)),
                pool: 1.0,
            }
            if i == 0:
                res[f"TPU-{self.accelerator_type}-head"] = 1.0
            out.append(res)
        return out

    def create_node(self, resources: Dict[str, float]) -> ProviderNode:
        pool = f"{self.node_pool_prefix}-{uuid.uuid4().hex[:6]}"
        hosts = self.backend.create_hosts(pool,
                                          self._host_resources(pool))
        node = ProviderNode(
            provider_id=pool,
            node_id_hex=hosts[0].get("node_id_hex"),
            handle={"pool": pool, "hosts": hosts})
        self._nodes[pool] = node
        return node

    @staticmethod
    def _topology_for(chips: int) -> str:
        # v5p topologies: 4 chips per host; topology and --num-nodes
        # derive from the same chip count — reject sizes we can't spell
        # rather than emitting an inconsistent pool spec
        hosts = max(1, chips // 4)
        topo = {1: "2x2x1", 2: "2x2x2", 4: "2x2x4", 8: "2x4x4",
                16: "4x4x4"}.get(hosts)
        if topo is None:
            raise ValueError(
                f"unsupported v5p slice size: {chips} chips "
                f"({hosts} hosts); supported hosts: 1,2,4,8,16")
        return topo

    def terminate_node(self, node: ProviderNode) -> None:
        self.backend.delete_hosts(node.provider_id)
        self._nodes.pop(node.provider_id, None)

    def non_terminated_nodes(self) -> List[ProviderNode]:
        return list(self._nodes.values())


class StandardAutoscaler:
    """Polls cluster load via the GCS; scales worker nodes between
    min_workers and max_workers. Scale-up when leases are queued anywhere
    (work the current nodes can't place); scale-down when a provider node
    sits idle past idle_timeout_s."""

    def __init__(self, gcs_address: str, provider: NodeProvider, *,
                 resources_per_node: Optional[Dict[str, float]] = None,
                 node_types: Optional[List[Any]] = None,
                 min_workers: int = 0, max_workers: int = 4,
                 idle_timeout_s: float = 30.0, poll_period_s: float = 2.0,
                 load_fn: Optional[Any] = None):
        from ray_tpu_torch._private import rpc as rpc_lib
        from ray_tpu_torch.autoscaler.demand_scheduler import NodeType

        if gcs_address:
            host, port = gcs_address.rsplit(":", 1)
            self._gcs = rpc_lib.RpcClient((host, int(port)), timeout=60)
        else:
            self._gcs = None  # test mode: load injected via load_fn
        self._pool = rpc_lib.ClientPool(timeout=30)
        self.provider = provider
        self.resources_per_node = dict(resources_per_node or {"CPU": 2.0})
        # heterogeneous launchable shapes for the demand scheduler
        # (reference available_node_types); default: one type matching
        # resources_per_node
        self.node_types = list(node_types or [
            NodeType("default", dict(self.resources_per_node),
                     max_workers=max_workers)])
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self.poll_period_s = poll_period_s
        self._load_fn = load_fn
        self._idle_since: Dict[str, float] = {}
        self.num_scale_ups = 0
        self.num_scale_downs = 0
        self.last_unplaceable: List[Dict[str, float]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _cluster_load(self) -> Dict[str, Any]:
        """Queued lease shapes, per-node availability, busy workers."""
        out: Dict[str, Any] = {"pending": 0, "pending_shapes": [],
                               "available": [], "busy_by_node": {}}
        if self._load_fn is not None:
            out.update(self._load_fn())
            out["pending"] = max(out.get("pending", 0),
                                 len(out.get("pending_shapes", [])))
            return out
        try:
            nodes = [n for n in self._gcs.call("get_all_nodes") if n.alive]
        except Exception:  # noqa: BLE001
            return out
        for n in nodes:
            try:
                info = self._pool.get(tuple(n.address)).call("nm_get_info")
                workers = self._pool.get(tuple(n.address)).call(
                    "nm_list_workers")
            except Exception:  # noqa: BLE001 - node died mid-poll; skip this round
                continue
            out["pending"] += info.get("num_pending_leases", 0)
            out["pending_shapes"].extend(
                info.get("pending_resource_shapes") or [])
            out["available"].append(dict(info.get("available") or {}))
            out["busy_by_node"][n.node_id.hex()] = sum(
                1 for w in workers if not w["idle"])
        return out

    def run_once(self) -> None:
        from ray_tpu_torch.autoscaler.demand_scheduler import get_nodes_to_launch
        load = self._cluster_load()
        nodes = self.provider.non_terminated_nodes()
        # ---- scale up: bin-pack unplaced demand into candidate node
        # shapes (reference resource_demand_scheduler.py) -------------
        shapes = list(load.get("pending_shapes") or [])
        if not shapes and load["pending"]:
            # older node managers report counts only: assume 1-CPU tasks
            shapes = [{"CPU": 1.0}] * int(load["pending"])
        if len(nodes) < self.min_workers:
            # node-COUNT floor, not capacity demand: launch directly
            # (head-node availability must not satisfy min_workers)
            self.provider.create_node(dict(self.resources_per_node))
            self.num_scale_ups += 1
            self._emit("AUTOSCALER_SCALE_UP",
                       f"below min_workers={self.min_workers}",
                       nodes_before=len(nodes))
            return
        if shapes and len(nodes) < self.max_workers:
            to_launch, unplaceable = get_nodes_to_launch(
                shapes, list(load.get("available") or []),
                self.node_types,
                max_total_nodes=self.max_workers + 1)  # +1: head node
            self.last_unplaceable = unplaceable
            launched = 0
            for type_name, count in to_launch.items():
                t = next(t for t in self.node_types
                         if t.name == type_name)
                for _ in range(count):
                    if len(self.provider.non_terminated_nodes()) >= \
                            self.max_workers:
                        break
                    logger.info(
                        "autoscaler: launching %s for %d queued "
                        "demands", type_name, len(shapes))
                    self.provider.create_node(dict(t.resources))
                    self.num_scale_ups += 1
                    launched += 1
            if launched:
                self._emit("AUTOSCALER_SCALE_UP",
                           f"{len(shapes)} queued demands -> "
                           f"{launched} nodes",
                           nodes_before=len(nodes))
                return
        # ---- scale down idle provider nodes ------------------------
        now = time.monotonic()
        for node in nodes:
            if len(self.provider.non_terminated_nodes()) <= \
                    self.min_workers:
                break
            busy = load["busy_by_node"].get(node.node_id_hex, 0)
            if busy == 0 and load["pending"] == 0:
                first_idle = self._idle_since.setdefault(
                    node.provider_id, now)
                if now - first_idle >= self.idle_timeout_s:
                    logger.info("autoscaler: terminating idle node %s",
                                node.provider_id)
                    self._emit("AUTOSCALER_SCALE_DOWN",
                               f"node {node.provider_id} idle "
                               f"{self.idle_timeout_s:.0f}s")
                    self.provider.terminate_node(node)
                    self._idle_since.pop(node.provider_id, None)
                    self.num_scale_downs += 1
            else:
                self._idle_since.pop(node.provider_id, None)

    def _emit(self, event_type: str, message: str, **fields) -> None:
        if self._gcs is None:  # provider-only test mode
            return
        from ray_tpu_torch._private.events import emit_via
        emit_via(self._gcs.call, "autoscaler", event_type, message,
                 **fields)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_period_s):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001
                logger.exception("autoscaler iteration failed")
