"""The kernel check of chip_smoke.py, on the CPU: it accepts outputs that
carry the kernels' own rounding (P and dS rounded to bf16 before their
products, bf16 outputs) and rejects a kernel that drops the ragged last
V tile from the product while keeping its keys in the softmax sum."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as pflash

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B, T, H, D = 1, 200, 2, 64   # T ragged against the kernels' 64-row tiles
TILE = 64


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _outputs():
    """Plain f32 outputs and outputs with the kernels' rounding, [B,T,H,D]."""
    rng = np.random.default_rng(0)
    q, k, v, do = (_bf16(torch.from_numpy(rng.standard_normal(
        (B, T, H, D)).astype(np.float32))) for _ in range(4))
    scale = D ** -0.5
    o_ref, lse = pflash.flash_fwd_ref(q, k, v, scale, True)
    di = pflash.row_dot(o_ref, do)
    dk_ref, dv_ref = pflash.flash_bwd_dkv_ref(q, k, v, do, lse, di, scale, True)
    dq_ref = pflash.flash_bwd_dq_ref(q, k, v, do, lse, di, scale, True)

    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))  # [B,H,T,D]
    s = (qh @ kh.transpose(-1, -2)) * scale
    keep = torch.ones(T, T, dtype=torch.bool).tril()
    s = s.masked_fill(~keep, float("-inf"))
    pu = torch.exp(s - s.amax(-1, keepdim=True))   # unnormalised, as online
    rows = pu.sum(-1, keepdim=True)
    o = _bf16((_bf16(pu) @ vh) / rows)
    v_cut = vh.clone()
    v_cut[:, :, T // TILE * TILE:] = 0.0           # the planted fault
    o_fault = _bf16((_bf16(pu) @ v_cut) / rows)
    p = torch.exp(s - lse[..., None])
    dv = _bf16(_bf16(p).transpose(-1, -2) @ doh)
    ds = _bf16(p * (doh @ vh.transpose(-1, -2) - di[..., None]))
    dk = _bf16(ds.transpose(-1, -2) @ qh * scale)
    dq = _bf16(ds @ kh * scale)
    back = lambda x: x.transpose(1, 2)             # noqa: E731
    return {"o": (back(o), o_ref), "dk": (back(dk), dk_ref),
            "dv": (back(dv), dv_ref), "dq": (back(dq), dq_ref),
            "o_fault": (back(o_fault), o_ref)}


@pytest.fixture(scope="module")
def outputs():
    return _outputs()


@pytest.mark.parametrize("out", ["o", "dk", "dv", "dq"])
def test_check_accepts_kernel_rounding(outputs, out):
    a, ref = outputs[out]
    # well inside the allowance, so the card's ~60000x more elements
    # (the largest of them a few sigma further out) still fit
    assert chip_smoke.excess(a, ref) < 0.5


def test_check_rejects_ragged_v_fault(outputs):
    a, ref = outputs["o_fault"]
    assert chip_smoke.excess(a, ref) > 2.0


def test_check_fails_on_nan():
    ref = torch.ones(1, 4, 1, 8)
    a = ref.clone()
    a[0, 1, 0, 3] = float("nan")
    assert not chip_smoke.excess(a, ref) <= 1.0
