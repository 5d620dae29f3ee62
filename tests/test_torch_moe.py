"""The port's MoE (ops/moe.py) and MoE Transformer against the JAX
package's, on the CPU in f32.

- moe_ffn alone, from the same params and tokens: y, the aux loss and
  the grads of sum(y * w) + aux (w a fixed weight per feature) against
  the JAX moe_ffn and jax.grad, top-2 with ample capacity (4.0) and
  with drops (0.5), and top-1 (1.25: a top-1 router's grad is its aux
  term's alone, its gates being 1, and where every expert fills to
  capacity the aux is constant too): y and aux at rtol
  1e-5 / atol 1e-6, each grad within 1e-4 of its norm. The dense
  reference equals JAX's and the ample-capacity moe_ffn
  (tests/test_pp_moe.py::TestMoE), and a tight capacity zeroes rows.
- One spawn of 8 gloo ranks (tests/_torch_sharded_workers.py, job
  "moe_step"): TINY with 4 experts, top-2, capacity factor 1.0 (tight:
  some pairs are dropped, so the capacity and each pair's place must be
  the global batch's) on data=2 x expert=4, AdamW 1e-2 (optax's default
  decay 1e-4), on 8 x 33 tokens (tests/test_pp_moe.py::
  TestFlagshipIntegration::test_transformer_moe_layers_train_on_expert_mesh):
  the first step's grads against jax.grad of the JAX loss (each within
  1e-4 of its norm), 3 steps' losses (1e-5 relative) and final params
  (1e-4 relative norm) against the JAX step on the same mesh, the
  expert weights Shard-ed over `expert` (each rank holds one expert), and
  a sharded checkpoint of the expert-placed params read back equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import _torch_sharded_workers as workers
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.ops.moe import MOE_PARAM_SPECS as JMOE_PARAM_SPECS
from ray_tpu.ops.moe import init_moe_params as jinit
from ray_tpu.ops.moe import moe_ffn as jmoe_ffn
from ray_tpu.ops.moe import moe_ffn_dense_reference as jdense
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ray_tpu_torch.models import TINY, Transformer
from ray_tpu_torch.ops.moe import (MOE_PARAM_SPECS, init_moe_params, moe_ffn,
                                   moe_ffn_dense_reference)
from ray_tpu_torch.parallel import MeshConfig, get_abstract_mesh
from ray_tpu_torch.parallel.sharding import flatten_specs, logical_sharding

STEPS = workers.STEPS
CAPACITY = 1.0   # tight: the step drops pairs

# (tokens, d_model, d_ff, experts, top-k, capacity factor)
FFN_CASES = {"ample": (24, 16, 32, 4, 2, 4.0),
             "drops": (64, 16, 32, 4, 2, 0.5),
             "top-1": (32, 8, 16, 4, 1, 1.25)}


def _close_by_norm(got, want, tol, what):
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= tol, f"{what}: relative norm error {err:.3e}"


def _ffn_inputs(case):
    """init_moe_params's distributions, drawn with numpy, and tokens."""
    n, d, f, e, _, _ = FFN_CASES[case]
    rng = np.random.default_rng(1)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    params = {"w_router": normal(d, e) * 0.02,
              "w_up": normal(e, d, f) * np.float32((2.0 / d) ** 0.5),
              "w_down": normal(e, f, d) * np.float32((2.0 / f) ** 0.5)}
    return params, normal(n, d)


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    _, d, _, _, k, cf = FFN_CASES[case]
    params, x = _ffn_inputs(case)
    weight = np.linspace(-1.0, 1.0, d, dtype=np.float32)

    def jloss(p, x):
        y, aux = jmoe_ffn(p, x, num_selected=k, capacity_factor=cf)
        return jnp.sum(y * weight) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, x)
    tp = {n: torch.tensor(a, requires_grad=True) for n, a in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = moe_ffn(tp, tx, num_selected=k, capacity_factor=cf)
    (torch.sum(y * torch.tensor(weight)) + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    _close_by_norm(tx.grad.numpy(), np.asarray(jgx), 1e-4, "x")
    for n in params:
        _close_by_norm(tp[n].grad.numpy(), np.asarray(jgp[n]), 1e-4, n)
    if case == "drops":   # some tokens lose every slot
        assert (np.abs(np.asarray(jy)).sum(-1) == 0).any()


def test_dense_reference_matches_jax_and_ample_capacity():
    params, x = _ffn_inputs("ample")
    tp = {n: torch.tensor(a) for n, a in params.items()}
    dense = moe_ffn_dense_reference(tp, torch.tensor(x), num_selected=2)
    want = jax.jit(lambda p, x: jdense(p, x, num_selected=2))(params, x)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    y, aux = moe_ffn(tp, torch.tensor(x), num_selected=2, capacity_factor=4.0)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert aux.item() > 0.0


def test_capacity_drops_tokens():
    params = init_moe_params(2, 8, 16, 2, device="cpu")
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (16, 8)).astype(np.float32))
    tight, _ = moe_ffn(params, x, num_selected=1, capacity_factor=0.25)
    ample, _ = moe_ffn(params, x, num_selected=1, capacity_factor=4.0)
    assert (tight.abs().sum(-1) == 0).sum() > (ample.abs().sum(-1) == 0).sum()


def test_param_specs_and_init_are_the_jax_ones():
    assert MOE_PARAM_SPECS == JMOE_PARAM_SPECS
    p = init_moe_params(0, 16, 32, 4, device="cpu")
    j = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), 16, 32, 4))
    assert {n: (tuple(a.shape), a.dtype) for n, a in p.items()} == {
        n: (tuple(a.shape), torch.float32) for n, a in j.items()}
    cfg = TINY.replace(moe_experts=4)
    jcfg = JTINY.replace(moe_experts=4)
    assert flatten_specs(Transformer.param_specs(cfg)) == \
        flatten_specs(JTransformer.param_specs(jcfg))
    shapes = {n: tuple(p.shape) for n, p in
              Transformer(cfg, device="meta").named_parameters()}
    jshapes = jax.eval_shape(lambda: JTransformer.init(
        jax.random.PRNGKey(0), jcfg))
    assert shapes == {n: tuple(a.shape) for n, a in
                      _flat_tree(jshapes).items()}
    mesh = get_abstract_mesh(MeshConfig(data=2, expert=4), 8)
    up = logical_sharding(Transformer.param_specs(cfg)["layers"]["w_moe_up"],
                          mesh)
    assert mesh.axis_names == ("data", "fsdp", "expert", "tensor")
    assert up[2].is_shard(1)


def _flat_tree(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": a for n, a in v.items()})
        else:
            out[k] = v
    return out


def _jax_step(params, batch):
    cfg = JTINY.replace(dtype="float32", moe_experts=4, moe_top_k=2,
                        loss_chunk=0, moe_capacity_factor=CAPACITY)
    mesh = jax_make_mesh(JMeshConfig(data=2, fsdp=1, expert=4),
                         devices=jax.devices()[:8])
    init, step = jax_make_train_step(
        lambda p, b: JTransformer.loss(p, b, cfg, mesh=mesh),
        JTransformer.param_specs(cfg), mesh, optimizer=optax.adamw(1e-2))
    state = init(jax.tree.map(jnp.asarray, params))
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    grads = jax.jit(jax.grad(lambda p: JTransformer.loss(p, batch, cfg)))(
        params)
    return {"loss": losses,
            "params": {n: np.asarray(a) for n, a in
                       _flat_tree(jax.device_get(state["params"])).items()},
            "grads": {n: np.asarray(a) for n, a in _flat_tree(grads).items()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    jcfg = JTINY.replace(dtype="float32", moe_experts=4, moe_top_k=2,
                         loss_chunk=0, moe_capacity_factor=CAPACITY)
    params = jax.tree.map(np.asarray,
                          JTransformer.init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (8, 33)).astype(np.int32)
    (tmp / "ckpt").mkdir()
    ranks = workers.start("moe_step", {
        "params": params, "batch": {"tokens": tokens},
        "capacity_factor": CAPACITY, "ckpt_dir": str(tmp / "ckpt")},
        8, str(tmp))
    ref = _jax_step(params, {"tokens": tokens})
    return ranks.result(timeout=120), ref


def test_moe_step_grads_match_jax_grad(run):
    got, ref = run
    for name, want in ref["grads"].items():
        _close_by_norm(got["grads"][name], want, 1e-4, name)
    # the tight capacity drops pairs (a share of them, per layer)
    assert ((got["dropped"] > 0) & (got["dropped"] < 0.5)).all(), \
        got["dropped"]


def test_moe_step_matches_jax_over_three_steps(run):
    got, ref = run
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for name, want in ref["params"].items():
        _close_by_norm(got["params"][name], want, 1e-4, name)


def test_experts_sharded_over_expert_and_checkpointed(run):
    got, _ = run
    from torch.distributed.tensor import Replicate, Shard
    # (data, fsdp, expert, tensor): the expert dim over expert
    assert got["placements"]["layers.w_moe_up"] == (
        Replicate(), Replicate(), Shard(1), Replicate())
    assert got["placements"]["layers.w_router"] == (Replicate(),) * 4
    assert got["local_up"] == (2, 1, 64, 128)
    assert got["checkpoint"] == 0.0
