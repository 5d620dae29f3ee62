"""Carry weights from the JAX package's Transformer to the port's.

The port keeps the JAX parameter layout, so conversion is a rename (the
nested ``layers`` dict becomes ``layers.<name>`` keys) plus a copy into
torch. Takes numpy arrays, or anything np.asarray accepts (jax arrays),
without importing JAX. With a mesh, each param becomes a DTensor placed
by Transformer.param_specs, and only this rank's slice is copied to the
device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.configs import TransformerConfig, torch_dtype
from ray_tpu_torch.parallel.sharding import (ShardingRules, flatten_specs,
                                             local_slices, logical_sharding)


def _to_torch(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                        dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device: DeviceLike = None, *, mesh=None,
                    rules: Optional[ShardingRules] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX Transformer.init tree -> the port Transformer's state_dict, in
    cfg.param_dtype on `device` (CUDA when None). With a mesh (a
    DeviceMesh from make_mesh over `device`'s type) each value is a
    DTensor holding this rank's slice only, placed as `rules` (the
    default rules when None) resolve Transformer.param_specs(cfg)."""
    from ray_tpu_torch.models.transformer import Transformer
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    flat: Dict[str, Any] = {}
    for name, value in tree.items():
        if name == "layers":
            flat.update({f"layers.{n}": a for n, a in value.items()})
        else:
            flat[name] = value
    if mesh is None:
        return {n: _to_torch(a, pdt, dev) for n, a in flat.items()}
    specs = flatten_specs(Transformer.param_specs(cfg))
    out: Dict[str, torch.Tensor] = {}
    for name, a in flat.items():
        a = np.asarray(a)
        placements = logical_sharding(specs[name], mesh, rules,
                                      shape=a.shape)
        local = _to_torch(a[local_slices(a.shape, placements, mesh)], pdt,
                          dev)
        out[name] = DTensor.from_local(local, mesh, placements,
                                       run_check=False)
    return out
