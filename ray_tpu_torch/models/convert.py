"""Carry weights from the JAX package's Transformer to the port's.

The port keeps the JAX parameter layout, so conversion is a rename (the
nested ``layers`` dict becomes ``layers.<name>`` keys) plus a copy into
torch. Takes numpy arrays, or anything np.asarray accepts (jax arrays),
without importing JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.configs import TransformerConfig, torch_dtype


def _to_torch(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                        dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """JAX Transformer.init tree -> the port Transformer's state_dict, in
    cfg.param_dtype on `device` (CUDA when None)."""
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    out: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if name == "layers":
            for lname, arr in value.items():
                out[f"layers.{lname}"] = _to_torch(arr, pdt, dev)
        else:
            out[name] = _to_torch(value, pdt, dev)
    return out
