"""Cluster: multiple node managers as local processes sharing one GCS.

reference parity: python/ray/cluster_utils.py:108 — the single most
important testing idea in the reference (SURVEY.md §4): every distributed
behavior (spillback, cross-node object pull, STRICT_SPREAD, node death)
is testable on one machine by running real per-node daemons as separate
OS processes against one in-process GCS. add_node/remove_node/
wait_for_nodes mirror cluster_utils.py:174,247,303.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.rpc import RpcClient


@dataclass
class NodeHandle:
    """A started cluster node. The head runs in-process (HeadNode); added
    nodes are `node_main` subprocesses."""

    node_id_hex: str
    is_head: bool
    proc: Optional[subprocess.Popen] = None
    node_manager_address: str = ""
    info: Dict[str, Any] = field(default_factory=dict)

    @property
    def alive(self) -> bool:
        return self.proc is None or self.proc.poll() is None


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 connect: bool = False,
                 head_node_args: Optional[Dict[str, Any]] = None):
        self.head_node: Optional[NodeHandle] = None
        self._head: Optional[worker_mod.HeadNode] = None
        self.worker_nodes: List[NodeHandle] = []
        self._connected = False
        if initialize_head:
            self.add_node(**(head_node_args or {}))
            if connect:
                self.connect()

    # ---- properties ------------------------------------------------------
    @property
    def address(self) -> str:
        assert self._head is not None, "no head node"
        host, port = self._head.gcs.address
        return f"{host}:{port}"

    @property
    def gcs_address(self):
        assert self._head is not None, "no head node"
        return self._head.gcs.address

    def list_all_nodes(self) -> List[NodeHandle]:
        return ([self.head_node] if self.head_node else []) \
            + list(self.worker_nodes)

    # ---- lifecycle -------------------------------------------------------
    def add_node(self, wait: bool = True, *,
                 num_cpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 object_store_memory: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None) -> NodeHandle:
        """Start a node. The first call creates the head (GCS + head node
        manager, in-process); later calls spawn node_main subprocesses
        (reference cluster_utils.py:174)."""
        if self._head is None:
            self._head = worker_mod.HeadNode(
                resources=resources, num_cpus=num_cpus,
                object_store_memory=object_store_memory)
            nm = self._head.node_manager
            self.head_node = NodeHandle(
                node_id_hex=nm.node_id.hex(), is_head=True,
                node_manager_address=f"{nm.address[0]}:{nm.address[1]}")
            return self.head_node

        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.node_main",
               "--gcs-address", self.address,
               "--resources", json.dumps(res),
               "--labels", json.dumps(labels or {})]
        if object_store_memory:
            cmd += ["--object-store-memory", str(object_store_memory)]
        child_env = dict(os.environ)
        child_env.update(env or {})
        # Own process group so remove_node can kill the node manager AND
        # its worker processes in one shot (SIGKILLing only node_main
        # would orphan live workers — not a faithful node failure).
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=child_env, start_new_session=True)
        line = proc.stdout.readline().strip()
        if not line:
            rc = proc.poll()
            raise RuntimeError(f"node_main exited rc={rc} before handshake")
        info = json.loads(line)
        handle = NodeHandle(
            node_id_hex=info["node_id"], is_head=False, proc=proc,
            node_manager_address=info["node_manager_address"], info=info)
        self.worker_nodes.append(handle)
        if wait:
            self._wait_node_registered(handle.node_id_hex)
        return handle

    def remove_node(self, node: NodeHandle,
                    allow_graceful: bool = True,
                    wait_dead: bool = True, timeout: float = 30.0) -> None:
        """Stop a node (reference cluster_utils.py:247). allow_graceful
        sends SIGTERM (node manager unregisters and kills its workers);
        otherwise SIGKILL simulates node failure — death is then detected
        by GCS health checks."""
        assert not node.is_head, "cannot remove the head node"
        if node.proc is not None and node.proc.poll() is None:
            sig = signal.SIGTERM if allow_graceful else signal.SIGKILL
            try:
                os.killpg(node.proc.pid, sig)
            except ProcessLookupError:
                pass
            try:
                node.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(node.proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                node.proc.wait(timeout=5)
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)
        if wait_dead:
            self._wait_node_dead(node.node_id_hex, timeout=timeout)

    def wait_for_nodes(self, timeout: float = 30.0) -> None:
        """Block until every started node is registered and alive
        (reference cluster_utils.py:303)."""
        want = {n.node_id_hex for n in self.list_all_nodes()}
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = {n.node_id.hex() for n in self._get_nodes() if n.alive}
            if want <= alive:
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"nodes not all alive after {timeout}s: want {want}")

    def connect(self):
        import ray_tpu_torch
        out = ray_tpu_torch.init(address=self.address)
        self._connected = True
        return out

    def shutdown(self) -> None:
        if self._connected:
            import ray_tpu_torch
            ray_tpu_torch.shutdown()
            self._connected = False
        for node in list(self.worker_nodes):
            try:
                self.remove_node(node, allow_graceful=True, wait_dead=False)
            except Exception:  # noqa: BLE001 - node already dead
                pass
        if self._head is not None:
            self._head.shutdown()
            self._head = None
            self.head_node = None

    # ---- internals -------------------------------------------------------
    def _get_nodes(self):
        gcs = RpcClient(self.gcs_address, timeout=30)
        try:
            return gcs.call("get_all_nodes")
        finally:
            gcs.close()

    def _wait_node_registered(self, node_id_hex: str,
                              timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if any(n.node_id.hex() == node_id_hex and n.alive
                   for n in self._get_nodes()):
                return
            time.sleep(0.05)
        raise TimeoutError(f"node {node_id_hex} never registered")

    def _wait_node_dead(self, node_id_hex: str,
                        timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not any(n.node_id.hex() == node_id_hex and n.alive
                       for n in self._get_nodes()):
                return
            time.sleep(0.1)
        raise TimeoutError(f"node {node_id_hex} still alive in GCS")
