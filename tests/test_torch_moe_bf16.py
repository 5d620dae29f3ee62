"""The port's MoE experts at bf16 compute against the JAX package's, on
the CPU.

The JAX moe_ffn builds its dispatch one-hots in f32, so the experts'
input, both expert GEMMs, the gelu and the combine run in f32 even when
the transformer hands it bf16 activations and bf16 expert weights; only
the layer's output is cast back to bf16 (ray_tpu/models/transformer.py
:270-281). The port's experts compute in f32 from the same bf16 values.

- The layer: a TINY MoE model's layer-0 FFN (4 experts, top-2,
  capacity factor 1.25: seed 2 drops 3% of the pairs) from JAX
  Transformer.init params, its router f32 and its expert weights cast to
  bf16 as the transformer casts them, on bf16 hidden states (numpy, from
  a seed): y within 1e-5 relative norm of the JAX moe_ffn's, the aux
  loss within 1e-6. Experts in bf16 miss that bar by two orders (about
  3e-3: the bf16 rounding of the up GEMM's output, the gelu and the down
  GEMM).
- The model: the TINY MoE model's loss at bf16 compute against JAX
  Transformer.loss from the same params and tokens, rtol 1e-2, and its
  logits finite and f32. The two frameworks round the rest of a bf16
  layer at other places (tests/test_torch_models.py::
  test_bf16_loss_and_logits_match_jax holds the dense model to the same
  bar), and those roundings, not the experts', set the model's error.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.ops.moe import moe_ffn as jmoe_ffn
from ray_tpu_torch.models import TINY, Transformer
from ray_tpu_torch.ops.moe import moe

MOE = dict(moe_experts=4, moe_top_k=2, loss_chunk=0)
SEEDS = (0, 1, 2)
TOKENS = 64          # 2 rows of 32
Y_RTOL = 1e-5        # relative norm, the layer's f32 output
AUX_ATOL = 1e-6


def _layer_inputs(seed):
    """Layer 0's router (f32) and expert weights (bf16), from JAX
    Transformer.init, and bf16 hidden states of the layer's width."""
    params = JTransformer.init(jax.random.PRNGKey(seed),
                               JTINY.replace(**MOE))
    lp = {n: np.array(a[0]) for n, a in params["layers"].items()}
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((TOKENS, TINY.d_model)).astype(np.float32)
    return lp, h


@pytest.mark.parametrize("seed", SEEDS)
def test_experts_compute_in_f32_as_jax_does(seed):
    lp, h = _layer_inputs(seed)
    jy, jaux = jax.jit(lambda lp, h: jmoe_ffn(
        {"w_router": lp["w_router"],
         "w_up": lp["w_moe_up"].astype(jnp.bfloat16),
         "w_down": lp["w_moe_down"].astype(jnp.bfloat16)},
        h.astype(jnp.bfloat16), num_selected=2,
        capacity_factor=TINY.moe_capacity_factor))(lp, h)
    assert jy.dtype == jnp.float32
    x = torch.from_numpy(h).to(torch.bfloat16).view(2, TOKENS // 2, -1)
    y, aux, dropped = moe(
        x, torch.from_numpy(lp["w_router"]),
        torch.from_numpy(lp["w_moe_up"]).to(torch.bfloat16),
        torch.from_numpy(lp["w_moe_down"]).to(torch.bfloat16),
        num_selected=2, capacity_factor=TINY.moe_capacity_factor)
    assert y.dtype == torch.float32
    jy = np.asarray(jy)
    err = np.linalg.norm(y.reshape(TOKENS, -1).numpy() - jy) / \
        np.linalg.norm(jy)
    assert err <= Y_RTOL, f"y: relative norm error {err:.3e}"
    np.testing.assert_allclose(aux.item(), float(jaux), atol=AUX_ATOL)
    assert 0.0 <= dropped.item() < 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_moe_model_loss_matches_jax(seed):
    cfg, jcfg = TINY.replace(**MOE), JTINY.replace(**MOE)
    assert cfg.dtype == "bfloat16"
    params = JTransformer.init(jax.random.PRNGKey(seed), jcfg)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    jloss = jax.jit(lambda p: JTransformer.loss(
        p, {"tokens": tokens}, jcfg))(params)
    model = Transformer(cfg, device="cpu")
    model.load_jax_params(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens[:, :-1]))
        loss = model.loss({"tokens": torch.from_numpy(tokens)})
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
