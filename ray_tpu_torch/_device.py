"""Device rule of the port, and what the card says about itself.

Entry points run on the card unless the caller names another device:
``resolve_device(None)`` is CUDA, and raises where there is no CUDA. It
never carries on quietly on the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Tuple, Union

import torch

DeviceLike = Union[None, str, torch.device]

# Dense bf16 tensor-core FLOP/s and memory bytes/s of the H100 SXM5
# (NVIDIA data sheet, at its full power limit), the card the port runs on.
_H100_SXM = ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> the current CUDA device, raising if there is none; anything
    else -> torch.device(device) as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def gpu_info() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def peak_rates(name: str) -> Tuple[float, float]:
    """(bf16 dense FLOP/s, memory bytes/s) of the card called `name`;
    raises for any card but the H100 SXM5."""
    known, flops, bw = _H100_SXM
    if name != known:
        raise ValueError(f"no published peaks known for {name!r}")
    return flops, bw
