"""TorchConfig: the torch.distributed process group over the train gang.

The port's counterpart of ray_tpu/train/jax_backend.py, merged with the
reference's gloo torch_backend.py (reference parity:
python/ray/train/torch/config.py:22,148-200 — _TorchBackend.on_start
picks rank 0's address and runs dist.init_process_group on every
worker). Where the JAX package starts jax.distributed, every worker here
joins one process group: NCCL when the workers hold GPUs, gloo
otherwise. It runs at world size 1 too, so dist.* calls in a loop work
unchanged and the card's NCCL path is the one a single worker takes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Type

from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    """backend=None (default) resolves per gang: "nccl" when the workers
    hold GPUs, "gloo" otherwise. timeout_s bounds the rendezvous and
    every collective of the group."""

    backend: Optional[str] = None
    timeout_s: int = 300

    @property
    def backend_cls(self) -> Type["Backend"]:
        return _TorchBackend


def _get_node_ip() -> str:
    """This worker's node address as the cluster knows it: the host of
    its node manager (127.0.0.1 for a local cluster)."""
    return os.environ["RAY_TPU_NODE_MANAGER"].rsplit(":", 1)[0]


def _free_port(host: str) -> int:
    from ray_tpu_torch._private.rpc import find_free_port
    return find_free_port(host)


def _worker_has_gpu() -> bool:
    """Whether this worker was given GPUs (the executor set its
    CUDA_VISIBLE_DEVICES before the backend starts)."""
    from ray_tpu_torch._private.accelerators.nvidia_gpu import \
        NvidiaGPUAcceleratorManager
    return bool(NvidiaGPUAcceleratorManager.
                get_current_process_visible_accelerator_ids())


def _init_process_group(master_addr: str, master_port: int, backend: str,
                        world_size: int, rank: int,
                        timeout_s: int) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    os.environ["MASTER_ADDR"] = master_addr
    os.environ["MASTER_PORT"] = str(master_port)
    if backend == "nccl":
        # the worker sees only its own cards; the first is its device
        torch.cuda.set_device(0)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{master_addr}:{master_port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def _destroy_process_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class _TorchBackend(Backend):
    def gang_env(self, backend_config: TorchConfig,
                 num_workers: int = 1) -> Optional[dict]:
        """Fresh worker processes for every gang formation: a worker's
        CUDA_VISIBLE_DEVICES must be set before anything in it touches
        CUDA, and an elastic re-form (new world size, new rendezvous)
        needs a clean process group in every member."""
        from ray_tpu_torch.train.elastic import gang_runtime_env
        return gang_runtime_env("RAY_TPU_TRAIN_GANG")

    def on_start(self, worker_group: WorkerGroup,
                 backend_config: TorchConfig) -> None:
        backend = backend_config.backend
        if backend is None:
            # probe worker 0, not the driver: the driver may sit on a
            # node without cards while the workers hold them
            backend = "nccl" if worker_group.execute_single(
                0, _worker_has_gpu) else "gloo"
        # rank 0's node hosts the rendezvous on a port picked fresh for
        # every formation: a re-form must not collide with the previous
        # formation's socket in TIME_WAIT (reference
        # torch/config.py:106-112 picks MASTER_ADDR from worker 0)
        ip = worker_group.execute_single(0, _get_node_ip)
        port = worker_group.execute_single(0, _free_port, ip)
        logger.debug("TorchBackend: %s group of %d at %s:%d", backend,
                     len(worker_group), ip, port)
        import ray_tpu_torch
        ray_tpu_torch.get([
            w.apply.remote(_init_process_group, ip, port, backend,
                           len(worker_group), rank,
                           backend_config.timeout_s)
            for rank, w in enumerate(worker_group.workers)
        ], timeout=backend_config.timeout_s + 60)

    def on_shutdown(self, worker_group: WorkerGroup,
                    backend_config: TorchConfig) -> None:
        import ray_tpu_torch
        try:
            ray_tpu_torch.get([w.apply.remote(_destroy_process_group)
                               for w in worker_group.workers], timeout=60)
        except Exception:  # noqa: BLE001 - workers may already be dead
            pass
