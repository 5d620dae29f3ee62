"""The port's microbatched pipeline (parallel/pipeline.py) and
Transformer.pipeline_loss against the JAX package's, on 8 gloo ranks.

One spawn of 8 ranks (tests/_torch_sharded_workers.py, job "pipeline")
runs, in f32, while the JAX references run here:
- make_pipeline_fn over pipe=2 x tensor=4 with tests/test_pp_moe.py::
  TestPipeline's two-stage tanh MLP (d 8, 4 microbatches of 4): the loss
  (1e-5 relative) and every grad (within 1e-4 of its norm) against the
  JAX pipeline's and jax.grad of it, each side's stages stacked by its
  stack_stage_params, as DTensors placed Shard(0) over pipe (their grads
  full_tensor()) and as plain tensors (each stage's rows, summed over
  pipe).
- TINY (dense attention, unchunked head) on data=4 x pipe=2, on 8 x 33
  tokens (TestFlagshipIntegration): pipeline_loss (n_stages 2, n_micro
  4, every rank the whole batch) equals the JAX Transformer.loss within
  1e-5 relative (the JAX test holds its pipeline_loss to 1e-4 absolute);
  Transformer.loss on that mesh, the layer stack gathered over pipe at
  use, gives the same loss and jax.grad's grads (each within 1e-4 of its
  norm).
- make_train_step with Transformer.param_specs training pipeline_loss on
  data=4 x pipe=2 (AdamW 1e-2, optax's default decay 1e-4) on 16 x 33
  tokens, 4 rows a data rank in 4 microbatches: 3 steps' losses and grad
  norms (1e-5 relative) and final params (1e-4 relative norm) against the
  JAX pipelined step on the same mesh (16 rows, n_micro 4); the layer
  stack stays Shard(0) over pipe, and a sharded checkpoint of the
  pipe-placed params reads back equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import _torch_sharded_workers as workers
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel.pipeline import make_pipeline_fn as jax_pipeline_fn
from ray_tpu.parallel.pipeline import \
    stack_stage_params as jax_stack_stage_params
from ray_tpu.parallel.train_step import make_train_step as jax_make_train_step

STEPS = workers.STEPS


def _close_by_norm(got, want, tol, what):
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= tol, f"{what}: relative norm error {err:.3e}"


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _mlp_stage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _mlp_data():
    rng = np.random.default_rng(0)
    d, mb, n_micro, n_stages = 8, 4, 4, 2

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    stages = [{"w1": normal(d, d, scale=0.5), "b1": normal(d, scale=0.1),
               "w2": normal(d, d, scale=0.5), "b2": normal(d, scale=0.1)}
              for _ in range(n_stages)]
    return {"stages": stages, "x": normal(n_micro, mb, d),
            "y": normal(n_micro, mb, d)}


def _jax_mlp(mlp):
    mesh = jax_make_mesh(JMeshConfig(data=1, fsdp=1, pipe=2, seq=1,
                                     tensor=4), devices=jax.devices()[:8])
    pipe = jax_pipeline_fn(_mlp_stage, 2, 4, mesh,
                           loss_fn=lambda o, t: jnp.mean((o - t) ** 2))
    loss, grads = jax.jit(jax.value_and_grad(pipe))(
        jax_stack_stage_params(mlp["stages"]), mlp["x"], mlp["y"])
    return {"loss": float(loss),
            "grads": {k: np.asarray(v) for k, v in grads.items()}}


def _jax_step(params, batch):
    cfg = JTINY.replace(dtype="float32", attention_impl="dense",
                        loss_chunk=0)
    mesh = jax_make_mesh(JMeshConfig(data=4, pipe=2),
                         devices=jax.devices()[:8])
    init, step = jax_make_train_step(
        lambda p, b: JTransformer.pipeline_loss(p, b, cfg, mesh=mesh,
                                                n_stages=2, n_micro=4),
        JTransformer.param_specs(cfg), mesh, optimizer=optax.adamw(1e-2))
    state = init(jax.tree.map(jnp.asarray, params))
    losses, gnorms = [], []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": gnorms,
            "params": _flat(jax.device_get(state["params"]))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    cfg = JTINY.replace(dtype="float32", attention_impl="dense",
                        loss_chunk=0)
    params = jax.tree.map(np.asarray,
                          JTransformer.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (8, 33)).astype(np.int32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (16, 33)).astype(np.int32)}
    mlp = _mlp_data()
    (tmp / "ckpt").mkdir()
    ranks = workers.start("pipeline", {
        "mlp": mlp, "params": params, "tokens": tokens, "batch": batch,
        "ckpt_dir": str(tmp / "ckpt")}, 8, str(tmp))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JTransformer.loss(p, {"tokens": tokens}, cfg)))(params)
    ref = {"mlp": _jax_mlp(mlp), "loss": float(loss),
           "grads": _flat(jax.device_get(grads)),
           "step": _jax_step(params, batch)}
    return ranks.result(timeout=120), ref


@pytest.mark.parametrize("kind", ["dtensor", "plain"])
def test_make_pipeline_fn_matches_jax(run, kind):
    got, ref = run
    got = got[f"mlp {kind}"]
    np.testing.assert_allclose(got["loss"], ref["mlp"]["loss"], rtol=1e-5)
    for name, want in ref["mlp"]["grads"].items():
        _close_by_norm(got["grads"][name], want, 1e-4, name)


def test_pipeline_loss_equals_loss(run):
    got, ref = run
    np.testing.assert_allclose(got["pipeline_loss"], ref["loss"], rtol=1e-5)


def test_loss_on_a_pipe_mesh_gathers_the_stack(run):
    from torch.distributed.tensor import Replicate, Shard
    got, ref = run
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for name, want in ref["grads"].items():
        _close_by_norm(got["loss grads"][name], want, 1e-4, name)
    # (data, fsdp, pipe, tensor): the stack over pipe
    assert got["layers placement"] == (Replicate(), Replicate(), Shard(0),
                                       Replicate())


def test_pipelined_step_matches_jax(run):
    got, ref = run
    np.testing.assert_allclose(got["step"]["loss"], ref["step"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["step"]["grad_norm"],
                               ref["step"]["grad_norm"], rtol=1e-5)
    for name, want in ref["step"]["params"].items():
        _close_by_norm(got["step"]["params"][name], want, 1e-4, name)
    assert got["checkpoint"] == 0.0
