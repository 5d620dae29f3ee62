"""The port's attention ops against the JAX package's, on the CPU.

Same inputs (numpy, from a seed) go through ray_tpu.ops.attention and
ray_tpu_torch.ops.attention in f32. On the CPU the JAX flash_attention
runs dense_attention, and the port's runs the plain versions of its CUDA
kernels; the kernels themselves are held against those plain versions on
the card by chip_smoke.py. Tolerances: 1e-5 for forward values, 1e-4 for
gradients (the same sums taken in another order).
"""

import numpy as np
import pytest

import jax
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    mha_reference_no_custom_vjp)

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as pattn
from ray_tpu_torch.ops import flash_attention as pflash


def _inputs(seed, b, t, hq, hkv, d, n=4):
    rng = np.random.default_rng(seed)
    shapes = [(b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, hq, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes[:n]]


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


def _jax_vjp(f, args, do):
    """(f(*args), its vjp at do), in one jitted call."""
    def run(args, do):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(do)
    out, grads = jax.jit(run)(tuple(args), do)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_dense_attention_matches_jax(causal, hq, hkv):
    q, k, v = _inputs(0, 2, 24, hq, hkv, 16, n=3)
    ref = np.asarray(jattn.dense_attention(q, k, v, causal=causal))
    out = pattn.dense_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_gqa_scores_and_pv_match_jax(hq, hkv):
    q, k, v = _inputs(1, 1, 12, hq, hkv, 8, n=3)
    s_ref = np.asarray(jattn.gqa_scores(q, k, 0.3))
    s = pattn.gqa_scores(_t(q), _t(k), 0.3)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5, atol=1e-5)
    p = np.asarray(jax.nn.softmax(s_ref, axis=-1))
    np.testing.assert_allclose(pattn.gqa_pv(_t(p), _t(v)).numpy(),
                               np.asarray(jattn.gqa_pv(p, v)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 256, 4, 64), (1, 128, 2, 128)])
def test_flash_attention_fwd_and_grads_match_jax(shape):
    b, t, h, d = shape
    q, k, v, do = _inputs(2, b, t, h, h, d)
    o_ref, grads_ref = _jax_vjp(
        lambda q, k, v: jattn.flash_attention(q, k, v, causal=True),
        (q, k, v), do)
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    o = pattn.flash_attention(qt, kt, vt, causal=True)
    o.backward(_t(do))
    np.testing.assert_allclose(o.detach().numpy(), o_ref,
                               rtol=1e-5, atol=1e-5)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_flash_attention_gqa_grads_match_jax():
    q, k, v, do = _inputs(3, 1, 32, 4, 2, 16)
    o_ref, grads_ref = _jax_vjp(
        lambda q, k, v: jattn.flash_attention(q, k, v, causal=True),
        (q, k, v), do)
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    o = pattn.flash_attention(qt, kt, vt, causal=True)
    o.backward(_t(do))
    np.testing.assert_allclose(o.detach().numpy(), o_ref,
                               rtol=1e-5, atol=1e-5)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---- the plain versions against JAX's own reference of the kernel -------

def _bhtd(x):
    return np.swapaxes(x, 1, 2)  # [B,T,H,D] <-> [B,H,T,D]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_ref_matches_library_reference(causal):
    q, k, v = _inputs(4, 2, 64, 3, 3, 32, n=3)
    scale = 32 ** -0.5
    o_ref = mha_reference_no_custom_vjp(
        _bhtd(q), _bhtd(k), _bhtd(v), causal=causal, sm_scale=scale)
    o, lse = pflash.flash_fwd_ref(_t(q), _t(k), _t(v), scale, causal)
    np.testing.assert_allclose(_bhtd(o.numpy()), np.asarray(o_ref),
                               rtol=1e-5, atol=1e-5)
    assert lse.shape == (2, 3, 64) and lse.dtype == torch.float32


def _library_grads(q, k, v, do, scale, causal):
    _, grads = _jax_vjp(
        lambda q, k, v: mha_reference_no_custom_vjp(
            q, k, v, causal=causal, sm_scale=scale),
        (_bhtd(q), _bhtd(k), _bhtd(v)), _bhtd(do))
    return [_bhtd(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dkv_ref_matches_library_vjp(causal):
    q, k, v, do = _inputs(5, 2, 64, 3, 3, 32)
    scale = 32 ** -0.5
    _, dk_ref, dv_ref = _library_grads(q, k, v, do, scale, causal)
    qt, kt, vt, dot = _t(q), _t(k), _t(v), _t(do)
    o, lse = pflash.flash_fwd_ref(qt, kt, vt, scale, causal)
    di = pflash.row_dot(o, dot)
    dk, dv = pflash.flash_bwd_dkv_ref(qt, kt, vt, dot, lse, di, scale, causal)
    np.testing.assert_allclose(dk.numpy(), dk_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dv.numpy(), dv_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dq_ref_matches_library_vjp(causal):
    q, k, v, do = _inputs(6, 2, 64, 3, 3, 32)
    scale = 32 ** -0.5
    dq_ref, _, _ = _library_grads(q, k, v, do, scale, causal)
    qt, kt, vt, dot = _t(q), _t(k), _t(v), _t(do)
    o, lse = pflash.flash_fwd_ref(qt, kt, vt, scale, causal)
    di = pflash.row_dot(o, dot)
    dq = pflash.flash_bwd_dq_ref(qt, kt, vt, dot, lse, di, scale, causal)
    np.testing.assert_allclose(dq.numpy(), dq_ref, rtol=1e-4, atol=1e-4)


def test_wrappers_use_plain_versions_on_cpu_and_count_no_launch():
    q, k, v, do = _inputs(7, 1, 16, 2, 2, 64)
    pflash.reset_launches()
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    o = pflash.FlashAttentionFn.apply(qt, kt, vt, 0.125, True)
    o.backward(_t(do))
    assert pflash.launches == {"flash_fwd": 0, "flash_bwd_dkv": 0,
                               "flash_bwd_dq": 0}
    ref, _ = pflash.flash_fwd_ref(qt, kt, vt, 0.125, True)
    torch.testing.assert_close(o, ref)
