"""Global per-process worker state + driver bootstrap.

reference parity: python/ray/_private/worker.py — the module-level Worker
singleton (`global_worker`, worker.py:411), `init` (worker.py:1165) and
`connect`/`shutdown` (worker.py:2122, :1742). Head bring-up hosts the GCS and
a node manager in-process (the reference spawns separate gcs_server/raylet
binaries via _private/services.py; a standalone-process mode exists via
`ray_tpu_torch._private.node_main` for the multi-node test harness).
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.ids import JobID

logger = logging.getLogger(__name__)


@dataclass
class Worker:
    core_worker: Any
    mode: str                      # "driver" | "worker"
    gcs_address: Tuple[str, int]
    node_manager_address: Tuple[str, int]
    node: Any = None               # head Node (driver-embedded services)
    namespace: str = ""

    @property
    def connected(self) -> bool:
        return self.core_worker is not None


_global_worker: Optional[Worker] = None
# Thin-client session when connected via ray_tpu_torch.init("ray://host:port")
# (reference util/client worker.py global client context).
_client_context = None


def client_context():
    return _client_context


def set_client_context(ctx) -> None:
    global _client_context
    _client_context = ctx


def global_worker() -> Worker:
    if _global_worker is None:
        raise RuntimeError(
            "ray_tpu_torch.init() has not been called in this process")
    return _global_worker


def global_worker_or_none() -> Optional[Worker]:
    return _global_worker


def set_global_worker(w: Optional[Worker]) -> None:
    global _global_worker
    _global_worker = w


class HeadNode:
    """Driver-embedded head services: GCS + node manager + session dir.

    reference parity: python/ray/_private/node.py Node(head=True) →
    start_head_processes (node.py:1300).
    """

    def __init__(self, resources: Optional[Dict[str, float]] = None,
                 num_cpus: Optional[float] = None,
                 object_store_memory: Optional[int] = None,
                 session_root: Optional[str] = None):
        from ray_tpu_torch._private.gcs import GcsServer
        from ray_tpu_torch._private.node_manager import NodeManager

        base = session_root or (
            "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir())
        self.session_dir = os.path.join(
            base, f"ray_tpu_session_{int(time.time() * 1000)}_{os.getpid()}")
        os.makedirs(self.session_dir, exist_ok=True)

        self.gcs = GcsServer()
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        self.node_manager = NodeManager(
            gcs_address=self.gcs.address, session_dir=self.session_dir,
            resources=res, is_head=True,
            object_store_capacity=object_store_memory)

    def shutdown(self) -> None:
        # local-only usage report (reference usage_lib, zero egress);
        # written NEXT TO the session dir so it survives the rmtree
        from ray_tpu_torch._private.usage import write_usage_report
        write_usage_report(
            os.path.dirname(self.session_dir),
            f"usage_stats_{os.path.basename(self.session_dir)}.json")
        self.node_manager.shutdown()
        self.gcs.shutdown()
        shutil.rmtree(self.session_dir, ignore_errors=True)


# actor id prefix -> display name (resolved once per actor via the GCS)
_actor_name_cache: Dict[str, str] = {}


def _actor_label(actor_prefix: str) -> str:
    label = _actor_name_cache.get(actor_prefix)
    if label is not None:
        return label
    label = f"actor-{actor_prefix[:8]}"
    try:
        w = global_worker_or_none()
        if w is not None:
            for info in w.core_worker._gcs.call("list_actors"):
                if info.actor_id.hex().startswith(actor_prefix):
                    label = info.name or \
                        f"{info.class_name}-{actor_prefix[:8]}"
                    break
    except Exception:  # noqa: BLE001 - GCS away; keep the id label
        pass
    _actor_name_cache[actor_prefix] = label
    return label


def _print_worker_logs(msg) -> None:
    """reference worker.py:1823 print_to_stdstream — driver-side sink
    for the worker_logs pubsub channel. stderr, so drivers that emit
    machine-readable stdout (bench JSON) stay parseable. Attributed
    records print with an (actor_name, node) prefix; the log monitor's
    per-source flood control reports shed lines via `dropped` and the
    notice keeps the count honest (`ray_tpu logs` still has them —
    only the live stream sheds)."""
    import sys
    try:
        node = msg["node_id"][:8]
        records = msg.get("records")
        if records:
            for rec in records:
                src = (_actor_label(rec["actor_id"]) if rec.get("actor_id")
                       else msg["worker"])
                # the driver's terminal IS the debug plane's sink here
                print(f"({src}, node={node}) "  # graftlint: disable=RT012
                      f"{rec.get('msg', '')}", file=sys.stderr)
        else:
            prefix = f"({msg['worker']}, node={node})"
            for line in msg["lines"]:
                print(f"{prefix} {line}",  # graftlint: disable=RT012
                      file=sys.stderr)
        if msg.get("dropped"):
            # the shed-line notice is itself terminal output
            print(f"({msg['worker']}, node={node}) "  # graftlint: disable=RT012
                  f"... flood control dropped {msg['dropped']} lines "
                  f"from this stream ({msg.get('dropped_total', 0)} "
                  f"total; `ray_tpu logs` has them)", file=sys.stderr)
    except Exception:  # noqa: BLE001 - printing logs must never kill the driver
        pass


def init(address: Optional[str] = None, *,
         resources: Optional[Dict[str, float]] = None,
         num_cpus: Optional[float] = None,
         object_store_memory: Optional[int] = None,
         namespace: str = "",
         ignore_reinit_error: bool = False,
         log_to_driver: bool = True,
         _session_root: Optional[str] = None) -> Worker:
    """Connect this process as a driver; bootstrap a head if no address."""
    global _global_worker
    if address is not None and address.startswith("ray://"):
        # client mode (reference ray.init("ray://...")): no local core
        # worker; everything proxies through the cluster-side server
        from ray_tpu_torch.client.worker import connect
        if _client_context is not None:
            if ignore_reinit_error:
                return _client_context
            raise RuntimeError("already connected in client mode")
        ctx = connect(address[len("ray://"):])
        ctx.namespace = namespace  # default for get_actor lookups
        set_client_context(ctx)
        return ctx
    if _global_worker is not None:
        if ignore_reinit_error:
            return _global_worker
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(use ignore_reinit_error=True)")

    from ray_tpu_torch._private.core_worker import CoreWorker
    from ray_tpu_torch._private.rpc import RpcClient

    node = None
    if address is None:
        node = HeadNode(resources=resources, num_cpus=num_cpus,
                        object_store_memory=object_store_memory,
                        session_root=_session_root)
    if node is not None:
        gcs_address = node.gcs.address
        nm_address = node.node_manager.address
        store_address = node.node_manager.store.address
        node_id_hex = node.node_manager.node_id.hex()
    else:
        host, port = address.rsplit(":", 1)
        gcs_address = (host, int(port))
        gcs = RpcClient(gcs_address, timeout=30)
        nodes = [n for n in gcs.call("get_all_nodes") if n.alive]
        if not nodes:
            raise RuntimeError(f"no alive nodes at {address}")
        head = next((n for n in nodes if n.is_head), nodes[0])
        nm_address = head.address
        store_address = head.store_address
        node_id_hex = head.node_id.hex()
        gcs.close()

    gcs = RpcClient(gcs_address, timeout=30)
    job_id: JobID = gcs.call("next_job_id")
    gcs.close()

    cw = CoreWorker(mode="driver", job_id=job_id, gcs_address=gcs_address,
                    node_manager_address=nm_address,
                    store_address=store_address, node_id_hex=node_id_hex)
    if log_to_driver:
        try:
            cw.subscribe("worker_logs", _print_worker_logs)
        except Exception:  # noqa: BLE001 - init proceeds without the
            # stream, but the operator should know why their console
            # is silent
            logger.warning("could not subscribe to worker log stream; "
                           "worker output will not reach this driver",
                           exc_info=True)
    _global_worker = Worker(core_worker=cw, mode="driver",
                            gcs_address=gcs_address,
                            node_manager_address=nm_address, node=node,
                            namespace=namespace)
    atexit.register(shutdown)
    return _global_worker


def shutdown() -> None:
    global _global_worker
    if _client_context is not None:
        _client_context.disconnect()
        set_client_context(None)
    w = _global_worker
    if w is None:
        return
    _global_worker = None
    try:
        w.core_worker._shutdown = True
        if w.node is not None:
            w.node.shutdown()
        w.core_worker.shutdown()
    except Exception:  # noqa: BLE001 - teardown; components may already be gone
        pass
    # drop cluster-scoped chaos context/rules (a re-init may join a
    # different cluster with different node ids and policy)
    from ray_tpu_torch._private import chaos as chaos_lib
    chaos_lib.client().reset()
    try:
        atexit.unregister(shutdown)
    except Exception:  # noqa: BLE001 - already unregistered
        pass


def is_initialized() -> bool:
    return _global_worker is not None or _client_context is not None
