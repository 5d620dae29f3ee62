"""The port's Transformer against the JAX package's, on the CPU.

JAX Transformer.init params go through params_from_jax into the port, and
the same tokens (numpy, from a seed) through both. f32 compute: logits
and losses agree to rtol 1e-5, every gradient to rtol 1e-4 / atol 1e-5
(the same sums in another order; the stacked-layer grads sum over more
terms). Configs: TINY (GQA, untied), an MHA tied variant of TINY, and a
narrow head_dim-128 variant that takes the flash path ("auto"), whose CPU
path is the plain version of the CUDA kernels.
"""

import functools

import numpy as np
import pytest

import jax
import torch

from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu_torch.models import TINY, Transformer
from ray_tpu_torch.models.convert import params_from_jax

T = 32
CHUNK = 8

CONFIGS = {
    "tiny_gqa": dict(dtype="float32"),
    "tiny_mha_tied": dict(dtype="float32", n_kv_heads=None,
                          tie_embeddings=True),
    "hd128_flash": dict(dtype="float32", d_model=256, n_heads=2,
                        n_kv_heads=None, d_ff=512, attention_impl="auto"),
}
VARIANTS = {  # name -> (loss_chunk, masked)
    "unchunked": (0, False),
    "chunked": (CHUNK, False),
    "masked": (0, True),
    "chunked_masked": (CHUNK, True),
}


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (2, T + 1)).astype(np.int32)
    mask = (rng.random((2, T)) > 0.3).astype(np.float32)
    return tokens, mask


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    jcfg = JTINY.replace(**CONFIGS[name])
    return jcfg, JTransformer.init(jax.random.PRNGKey(0), jcfg)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """JAX params (numpy) and logits."""
    jcfg, params = _jax_params(name)
    tokens, _ = _batch(1, jcfg.vocab_size)
    logits = jax.jit(lambda p: JTransformer.apply(p, tokens[:, :-1], jcfg))(
        params)
    return jax.tree.map(np.asarray, params), np.asarray(logits)


@functools.lru_cache(maxsize=None)
def _reference_loss(name, variant):
    """JAX (loss, flat grads) of one loss variant. Each is its own jit:
    one XLA compile per variant is cheaper here than one for all."""
    jcfg, params = _jax_params(name)
    chunk, masked = VARIANTS[variant]
    tokens, mask = _batch(1, jcfg.vocab_size)
    batch = {"tokens": tokens, **({"mask": mask} if masked else {})}
    cfg = jcfg.replace(loss_chunk=chunk)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JTransformer.loss(p, batch, cfg)))(params)
    return float(loss), _flat(grads)


def _port(name, **over):
    np_params, _ = _reference(name)
    cfg = TINY.replace(**CONFIGS[name], **over)
    model = Transformer(cfg, device="cpu")
    model.load_jax_params(np_params)
    return model


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_jax(name):
    _, logits = _reference(name)
    tokens, _ = _batch(1, TINY.vocab_size)
    model = _port(name)
    out = model(torch.from_numpy(tokens[:, :-1]))
    assert out.dtype == torch.float32 and out.shape == logits.shape
    np.testing.assert_allclose(out.detach().numpy(), logits,
                               rtol=1e-5, atol=1e-5)


# TINY in every variant; the tied head's own chunked path; the flash path.
# (Each JAX case is an XLA compile of about 2 s, so the matrix is sparse
# where the code paths are shared.)
LOSS_CASES = [("tiny_gqa", v) for v in VARIANTS] + [
    ("tiny_mha_tied", "unchunked"), ("tiny_mha_tied", "chunked"),
    ("hd128_flash", "unchunked")]


@pytest.mark.parametrize("name,variant", LOSS_CASES)
def test_loss_and_grads_match_jax(name, variant):
    loss_ref, grads_ref = _reference_loss(name, variant)
    chunk, masked = VARIANTS[variant]
    tokens, mask = _batch(1, TINY.vocab_size)
    model = _port(name, loss_chunk=chunk)
    batch = {"tokens": torch.from_numpy(tokens)}
    if masked:
        batch["mask"] = torch.from_numpy(mask)
    loss = model.loss(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=1e-5)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(grads_ref)
    for n, g in grads.items():
        np.testing.assert_allclose(g, grads_ref[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_param_layout_and_count_match_jax():
    np_params, _ = _reference("tiny_gqa")
    sd = params_from_jax(np_params, TINY, device="cpu")
    model = Transformer(TINY, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert sum(p.numel() for p in model.parameters()) == TINY.num_params


def test_explicit_positions_match_jax():
    name = "tiny_gqa"
    np_params, _ = _reference(name)
    jcfg = JTINY.replace(**CONFIGS[name])
    tokens, _ = _batch(2, TINY.vocab_size)
    positions = np.arange(5, 5 + T, dtype=np.int32)[None, :]
    ref = np.asarray(JTransformer.apply(np_params, tokens[:, :-1], jcfg,
                                        positions=positions))
    out = _port(name)(torch.from_numpy(tokens[:, :-1]),
                      positions=torch.from_numpy(positions))
    np.testing.assert_allclose(out.detach().numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_causality():
    """Changing a future token must not change past logits."""
    model = _port("tiny_gqa")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, TINY.vocab_size, (1, 16)))
    logits_a = model(tokens)
    tokens_b = tokens.clone()
    tokens_b[0, 10] = (tokens[0, 10] + 1) % TINY.vocab_size
    logits_b = model(tokens_b)
    np.testing.assert_allclose(logits_a[0, :10].detach().numpy(),
                               logits_b[0, :10].detach().numpy(), atol=1e-5)
    assert not np.allclose(logits_a[0, 10:].detach().numpy(),
                           logits_b[0, 10:].detach().numpy())


def test_bf16_loss_and_logits_match_jax():
    """bf16 compute, f32 params (TINY's own dtypes). bf16 keeps 8 bits of
    mantissa and the two frameworks round at different places (the
    RMSNorm cast, silu, the projections' outputs), so logits agree to
    atol 5e-2 on values of order 1 and the loss to rtol 1e-2."""
    params = JTransformer.init(jax.random.PRNGKey(0), JTINY)
    tokens, _ = _batch(4, TINY.vocab_size)
    loss_ref, logits_ref = jax.jit(lambda p: (
        JTransformer.loss(p, {"tokens": tokens}, JTINY),
        JTransformer.apply(p, tokens[:, :-1], JTINY)))(params)
    model = Transformer(TINY, device="cpu")
    model.load_jax_params(jax.tree.map(np.asarray, params))
    logits = model(torch.from_numpy(tokens[:, :-1]))
    loss = model.loss({"tokens": torch.from_numpy(tokens)})
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_ref), atol=5e-2)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-2)
