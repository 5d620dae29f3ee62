"""The port's make_train_step against the JAX package's, on the CPU.

The same TINY params (JAX Transformer.init) and tokens (numpy, from a
seed) go into both; 10 AdamW steps (lr 1e-3, weight decay 0.01), f32
compute. The JAX side runs make_train_step with optax.adamw on a
one-device mesh. Loss, grad norm and the final params agree to rtol 1e-4:
f32 sums in another order, compounded over ten steps. The params also
get atol 1e-5, 1% of one step's lr: Adam divides each grad by its own
running RMS, so an element whose grad is near zero turns its f32
rounding into an update of up to lr.
"""

import numpy as np
import pytest

import jax
import optax
import torch

from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ray_tpu_torch.models import TINY, Transformer
from ray_tpu_torch.parallel.train_step import adamw, make_train_step

STEPS = 10


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def test_adamw_trajectory_matches_optax():
    jcfg = JTINY.replace(dtype="float32")
    params = JTransformer.init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 33)).astype(np.int32)

    mesh = make_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    j_init, j_step = jax_make_train_step(
        lambda p, b: JTransformer.loss(p, b, jcfg, mesh=mesh),
        JTransformer.param_specs(jcfg), mesh,
        optimizer=optax.adamw(1e-3, weight_decay=0.01))
    j_state = j_init(params)
    j_loss, j_gnorm = [], []
    for _ in range(STEPS):
        j_state, m = j_step(j_state, {"tokens": tokens})
        j_loss.append(float(m["loss"]))
        j_gnorm.append(float(m["grad_norm"]))

    model = Transformer(TINY.replace(dtype="float32"), device="cpu")
    model.load_jax_params(np_params)
    p_init, p_step = make_train_step(
        lambda p, b: model.loss(b),
        optimizer=adamw(1e-3, weight_decay=0.01), device="cpu")
    p_state = p_init(dict(model.named_parameters()))
    p_loss, p_gnorm = [], []
    for i in range(STEPS):
        p_state, m = p_step(p_state, {"tokens": tokens})
        p_loss.append(m["loss"].item())
        p_gnorm.append(m["grad_norm"].item())
        assert m["step"] == i + 1

    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-4)
    np.testing.assert_allclose(p_gnorm, j_gnorm, rtol=1e-4)
    assert p_loss[-1] < p_loss[0]
    final = _flat(jax.device_get(j_state["params"]))
    for name, p in p_state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), final[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_default_optimizer_is_adamw_3e4_decay_001():
    model = Transformer(TINY, device="cpu")
    init, _ = make_train_step(lambda p, b: model.loss(b), device="cpu")
    opt = init(dict(model.named_parameters()))["opt_state"]
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["lr"], group["weight_decay"], group["betas"],
            group["eps"]) == (3e-4, 0.01, (0.9, 0.999), 1e-8)


def test_mesh_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="sharded train step"):
        make_train_step(lambda p, b: 0.0, None, object(), device="cpu")
