"""Accelerator plugin registry.

reference parity: python/ray/_private/accelerators/__init__.py — pluggable
per-family AcceleratorManager classes. The port runs on NVIDIA GPUs and
has no TPU, so the GPU manager is the only one registered.
"""

from __future__ import annotations

from typing import Dict, List, Type

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager
from ray_tpu_torch._private.accelerators.nvidia_gpu import (
    NvidiaGPUAcceleratorManager)

_MANAGERS: List[Type[AcceleratorManager]] = [NvidiaGPUAcceleratorManager]


def get_all_accelerator_managers() -> List[Type[AcceleratorManager]]:
    return list(_MANAGERS)


def get_accelerator_manager(resource_name: str) -> Type[AcceleratorManager]:
    for mgr in _MANAGERS:
        if mgr.get_resource_name() == resource_name:
            return mgr
    raise KeyError(f"no accelerator manager for resource '{resource_name}'")


def detect_node_accelerators() -> Dict[str, float]:
    """Autodetect accelerator resources on this node."""
    resources: Dict[str, float] = {}
    for mgr in _MANAGERS:
        n = mgr.get_current_node_num_accelerators()
        if n > 0:
            resources[mgr.get_resource_name()] = float(n)
            resources.update(mgr.get_current_node_additional_resources())
    return resources
