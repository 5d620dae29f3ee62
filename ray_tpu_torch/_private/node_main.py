"""Standalone node-manager process: `python -m ray_tpu_torch._private.node_main`.

The multi-node entry point: joins an existing cluster by GCS address and
hosts a NodeManager (worker pool + local scheduler + shared-memory object
store) until terminated. The reference's equivalent is the raylet binary
spawned by services.py (reference: python/ray/_private/services.py:1485,
src/ray/raylet/main.cc:119); here the daemon is this Python process.

Used by ray_tpu_torch.cluster_utils.Cluster (the reference
python/ray/cluster_utils.py:108 testing ladder: many node managers as
local processes sharing one GCS) and usable directly to join a real
second host:

    python -m ray_tpu_torch._private.node_main \
        --gcs-address <head-ip>:<port> --resources '{"CPU": 8}'
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--gcs-address", required=True,
                        help="host:port of the cluster's GCS")
    parser.add_argument("--session-dir", default=None,
                        help="session directory (default: a fresh tmp dir)")
    parser.add_argument("--resources", default="{}",
                        help='JSON resource dict, e.g. \'{"CPU": 4}\'')
    parser.add_argument("--labels", default="{}",
                        help="JSON node-label dict")
    parser.add_argument("--object-store-memory", type=int, default=None)
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args(argv)

    host, port = args.gcs_address.rsplit(":", 1)
    session_dir = args.session_dir
    if session_dir is None:
        base = "/dev/shm" if os.path.isdir("/dev/shm") \
            else tempfile.gettempdir()
        session_dir = os.path.join(
            base, f"ray_tpu_node_{int(time.time() * 1000)}_{os.getpid()}")
    os.makedirs(session_dir, exist_ok=True)

    from ray_tpu_torch._private.node_manager import NodeManager

    nm = NodeManager(
        gcs_address=(host, int(port)), session_dir=session_dir,
        resources=json.loads(args.resources) or None,
        labels=json.loads(args.labels) or None, host=args.host,
        object_store_capacity=args.object_store_memory)

    # Handshake line for cluster_utils / operators (single line, parseable).
    print(json.dumps({  # graftlint: disable=RT012
        "node_id": nm.node_id.hex(),
        "node_manager_address": f"{nm.address[0]}:{nm.address[1]}",
        "store_address": nm.store.address,
        "session_dir": session_dir,
    }), flush=True)

    stopping = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stopping.append(1))
    try:
        while not stopping:
            time.sleep(0.1)
    finally:
        nm.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
