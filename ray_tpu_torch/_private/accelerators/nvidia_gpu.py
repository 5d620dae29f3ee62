"""NVIDIA GPU accelerator manager: card discovery and visibility.

The port's counterpart of ray_tpu/_private/accelerators/tpu.py
(reference parity: python/ray/_private/accelerators/nvidia_gpu.py). The
node's cards are the resource "GPU"; a worker sees the ones named in
CUDA_VISIBLE_DEVICES. Detection runs in the node manager, so it neither
imports torch nor creates a CUDA context: it reads the environment and,
failing that, asks `nvidia-smi`.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import List, Optional

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager

logger = logging.getLogger(__name__)

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
# Test hook: pretend this many cards exist (the counterpart of
# RAY_TPU_FAKE_NUM_CHIPS for the chip-free ladder).
GPU_FAKE_NUM_ENV = "RAY_TPU_FAKE_NUM_GPUS"


def _nvidia_smi(*args: str) -> List[str]:
    """Lines nvidia-smi prints for `args`; [] where it is missing or
    fails (a node without a card)."""
    try:
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.debug("nvidia-smi unavailable: %s", e)
        return []
    if out.returncode != 0:
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


class NvidiaGPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return CUDA_VISIBLE_DEVICES_ENV

    @staticmethod
    def get_current_node_accelerator_ids() -> List[str]:
        """The ids of this node's cards, as CUDA_VISIBLE_DEVICES names
        them: from the fake count, else CUDA_VISIBLE_DEVICES when set,
        else one per line of `nvidia-smi -L`."""
        fake = os.environ.get(GPU_FAKE_NUM_ENV)
        if fake is not None:
            return [str(i) for i in range(int(fake))]
        visible = NvidiaGPUAcceleratorManager.\
            get_current_process_visible_accelerator_ids()
        if visible is not None:
            return visible
        cards = [ln for ln in _nvidia_smi("-L") if ln.startswith("GPU ")]
        return [str(i) for i in range(len(cards))]

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        return len(NvidiaGPUAcceleratorManager.
                   get_current_node_accelerator_ids())

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        """The first card's model from its name: "NVIDIA H100 80GB HBM3"
        -> "H100" (reference nvidia_gpu.py names types the same way)."""
        names = _nvidia_smi("--query-gpu=name", "--format=csv,noheader")
        if not names:
            return None
        words = names[0].split()
        if words[0] == "NVIDIA" and len(words) > 1:
            words = words[1:]
        return words[0]

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        v = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if v is None:
            return None
        return [s for s in v.split(",") if s]

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(i) for i in ids)
