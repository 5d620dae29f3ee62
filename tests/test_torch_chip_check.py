"""The kernel check of chip_smoke.py, on the CPU: it accepts outputs that
carry the kernels' own rounding (P and dS rounded to bf16 before their
products, bf16 outputs) and rejects a kernel that drops the ragged last
V tile from the product while keeping its keys in the softmax sum. dq's
query row 0, zero in exact arithmetic, is held to its rounding bound:
a dQ summed as the kernel sums it passes at any seed, and ordinary values
planted on that row fail."""

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
    dq_floor = chip_smoke.dq_row_floor(torch, pflash, q, k, v, do, o_ref, lse,
                                       scale, True)
    return {"o": (back(o), o_ref, None), "dk": (back(dk), dk_ref, None),
            "dv": (back(dv), dv_ref, None), "dq": (back(dq), dq_ref, dq_floor),
            "o_fault": (back(o_fault), o_ref, None)}


@pytest.fixture(scope="module")
def outputs():
    return _outputs()


@pytest.mark.parametrize("out", ["o", "dk", "dv", "dq"])
def test_check_accepts_kernel_rounding(outputs, out):
    a, ref, floor = outputs[out]
    # well inside the allowance, so the card's ~60000x more elements
    # (the largest of them a few sigma further out) still fit
    assert chip_smoke.excess(a, ref, floor) < 0.5


def test_check_rejects_ragged_v_fault(outputs):
    a, ref, floor = outputs["o_fault"]
    assert chip_smoke.excess(a, ref, floor) > 2.0


def test_check_fails_on_nan():
    ref = torch.ones(1, 4, 1, 8)
    a = ref.clone()
    a[0, 1, 0, 3] = float("nan")
    assert not chip_smoke.excess(a, ref) <= 1.0


def test_check_rejects_ordinary_values_on_the_zero_row(outputs):
    a, ref, floor = outputs["dq"]
    assert ref[:, 0].abs().max() < 1e-5     # zero in exact arithmetic
    bad = a.clone()
    bad[:, 0] = a[:, T // 2]
    assert chip_smoke.excess(bad, ref, floor) > 2.0
    bad[:, 0] = 0.01 * a[:, T // 2]         # still far above its rounding
    assert chip_smoke.excess(bad, ref, floor) > 1.0


def _dq_kernel_like(seed, b=1, t=384, h=2, d=128, step=16):
    """(dq as the kernel computes it, plain dq, its row floor) at one seed:
    S and dP summed in 16-deep steps, P by exp2 in log2 units, dS rounded
    to bf16, dQ summed in 16-key steps and rounded to bf16."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(torch.from_numpy(rng.standard_normal(
        (b, t, h, d)).astype(np.float32))) for _ in range(4))
    scale = d ** -0.5
    o_ref, lse = pflash.flash_fwd_ref(q, k, v, scale, True)
    di = pflash.row_dot(o_ref, do)
    dq_ref = pflash.flash_bwd_dq_ref(q, k, v, do, lse, di, scale, True)
    floor = chip_smoke.dq_row_floor(torch, pflash, q, k, v, do, o_ref, lse,
                                    scale, True)
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    chunks = lambda x, y: sum(                     # noqa: E731
        x[..., i:i + step] @ y[..., i:i + step].transpose(-1, -2)
        for i in range(0, d, step))
    log2e = 1.4426950408889634
    p = torch.exp2(chunks(qh, kh) * (scale * log2e) - lse[..., None] * log2e)
    p = p.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), 0.0)
    ds = _bf16(p * (chunks(doh, vh) - di[..., None]))
    dq = sum(ds[..., j:j + step] @ kh[..., j:j + step, :]
             for j in range(0, t, step))
    return _bf16(dq * scale).transpose(1, 2), dq_ref, floor


@pytest.mark.parametrize("seed", range(6))
def test_check_accepts_kernel_like_dq_at_any_seed(seed):
    dq, ref, floor = _dq_kernel_like(seed)
    assert chip_smoke.excess(dq, ref, floor) < 0.5
    # the zero row: the kernel's own rounding stays far inside its bound
    assert chip_smoke.excess(dq[:, :1], ref[:, :1], floor[:, :1]) < 0.1
