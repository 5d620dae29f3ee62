"""Worker process entrypoint.

reference parity: python/ray/_private/workers/default_worker.py — spawned by
the node manager's worker pool; connects a CoreWorker in worker mode and
serves task pushes until killed.
"""

from __future__ import annotations

import os
import signal
import sys
import threading


def main() -> None:
    # stdout/stderr land in the per-worker log file: route every line
    # (prints, logging, native chatter) through the debug plane's
    # attribution stamper so the log monitor can index it by
    # task/actor/trace id (see _private/log_plane.py); the wrapper
    # flushes per complete line so tails stay live
    from ray_tpu_torch._private import log_plane
    log_plane.init_worker_io("worker")
    import faulthandler
    # the raw fd, not the stamping wrapper: faulthandler runs in a
    # signal context and needs a real file (its dump lines parse as
    # RAW records)
    faulthandler.register(signal.SIGUSR1, file=log_plane.raw_stderr(),
                          all_threads=True)

    def parse_addr(s: str):
        host, port = s.rsplit(":", 1)
        return (host, int(port))

    gcs = parse_addr(os.environ["RAY_TPU_GCS"])
    nm = parse_addr(os.environ["RAY_TPU_NODE_MANAGER"])
    store = parse_addr(os.environ["RAY_TPU_STORE"])
    node_id_hex = os.environ["RAY_TPU_NODE_ID"]
    worker_id_hex = os.environ["RAY_TPU_WORKER_ID"]

    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.core_worker import CoreWorker
    from ray_tpu_torch._private.ids import JobID, WorkerID
    from ray_tpu_torch._private.rpc import RpcClient

    # Workers execute tasks from any job; job id is carried per-task.
    cw = CoreWorker(
        mode="worker", job_id=JobID.nil(), gcs_address=gcs,
        node_manager_address=nm, store_address=store,
        node_id_hex=node_id_hex, worker_id=WorkerID.from_hex(worker_id_hex))
    worker_mod.set_global_worker(worker_mod.Worker(
        core_worker=cw, mode="worker",
        gcs_address=gcs, node_manager_address=nm))

    nm_client = RpcClient(nm, timeout=60)
    nm_client.call("nm_register_worker", worker_id_hex=worker_id_hex,
                   address=cw.address)

    stop = threading.Event()

    def _term(signum, frame):  # noqa: ARG001
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    stop.wait()
    cw.shutdown()
    sys.exit(0)


if __name__ == "__main__":
    main()
