"""TensorFlow backend: TF_CONFIG wiring for TensorflowTrainer.

reference parity: python/ray/train/tensorflow/config.py —
_TensorflowBackend.on_start gathers every worker's (ip, port) and writes
the MultiWorkerMirroredStrategy TF_CONFIG env var on each worker:
{"cluster": {"worker": [addr0, addr1, ...]}, "task": {"type": "worker",
"index": rank}}. tf.distribute reads it at strategy construction.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import List, Type

from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.torch_backend import _get_node_ip
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TensorflowConfig(BackendConfig):
    @property
    def backend_cls(self) -> Type["Backend"]:
        return _TensorflowBackend


def _get_ip_and_port() -> str:
    from ray_tpu_torch._private.rpc import find_free_port
    return f"{_get_node_ip()}:{find_free_port()}"


def _set_tf_config(addresses: List[str], rank: int) -> None:
    import os
    os.environ["TF_CONFIG"] = json.dumps({
        "cluster": {"worker": addresses},
        "task": {"type": "worker", "index": rank},
    })


class _TensorflowBackend(Backend):
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: TensorflowConfig) -> None:
        import ray_tpu_torch
        addresses = ray_tpu_torch.get(
            [w.apply.remote(_get_ip_and_port)
             for w in worker_group.workers], timeout=120)
        ray_tpu_torch.get([
            w.apply.remote(_set_tf_config, addresses, rank)
            for rank, w in enumerate(worker_group.workers)
        ], timeout=120)
