"""Backend plugin contract.

reference parity: python/ray/train/backend.py:15,27 — BackendConfig /
Backend ABC with on_start / on_training_start / on_shutdown hooks run by
the BackendExecutor around worker-group lifecycle. The reference's
_TorchBackend does NCCL process-group setup here
(train/torch/config.py:148-200); the TPU build's JaxBackend instead wires
jax.distributed coordinator env + TPU slice visibility
(ray_tpu/train/jax_backend.py).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Type

if TYPE_CHECKING:
    from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclasses.dataclass
class BackendConfig:
    """Base config; subclasses carry framework-specific knobs."""

    @property
    def backend_cls(self) -> Type["Backend"]:
        return Backend


class Backend:
    """Framework setup hooks (all optional)."""

    share_cuda_visible_devices: bool = False

    def gang_env(self, backend_config: BackendConfig,
                 num_workers: int = 1) -> Optional[dict]:
        """Per-formation runtime_env for the worker gang, or None.

        A backend whose process-group runtime can only initialize in a
        FRESH process (jax.distributed must run before any other jax
        use) returns a runtime_env with a unique key here: every gang
        formation then gets its own worker-pool bucket of brand-new
        processes, which is what makes elastic re-formation (tearing a
        gang down and re-forming at a new world size) safe to repeat.
        `num_workers` is the formation's target world size, so an
        auto-mode backend can decide before any worker exists."""
        return None

    def on_start(self, worker_group: "WorkerGroup",
                 backend_config: BackendConfig) -> None:
        pass

    def on_training_start(self, worker_group: "WorkerGroup",
                          backend_config: BackendConfig) -> None:
        pass

    def on_shutdown(self, worker_group: "WorkerGroup",
                    backend_config: BackendConfig) -> None:
        pass
