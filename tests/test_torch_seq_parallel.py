"""The port's ring and Ulysses attention and the model over `seq`, on 8
gloo ranks, against the JAX package's on the 8-device virtual CPU mesh.

One spawn of 8 ranks (tests/_torch_sharded_workers.py, job
"seq_parallel") runs, in f32, while the JAX references run here:
- ring attention, causal and not, on seq=8 ([2, 64, 4, 16]: the case of
  tests/test_parallel.py::TestRingAttention), Ulysses on data=2 x seq=4
  ([2, 32, 8, 16]: TestUlyssesAttention), and ring and Ulysses with GQA
  (8 query heads, 2 kv heads, [2, 256, ., 16] on data=2 x seq=4:
  tests/test_long_context.py::TestRingGQA), each against
  ring_attention / ulysses_attention under shard_map: outputs at rtol
  2e-4, atol 2e-5 (the JAX tests' own bars), and the grads of q, k and v
  of sum(o * do) against jax.grad of the same, each within 1e-4 of its
  norm. The ring's exchange carries only kv-head-wide tensors (the
  port's form of TestRingGQA.test_ring_gqa_comm_volume_is_kv_width).
- TINY's logits with attention_impl "ring" and "ulysses" on data=2 x
  seq=4 (each rank its rows and columns, at global RoPE positions)
  against the JAX dense logits within 2e-4 (tests/test_models.py::
  test_sequence_parallel_matches_dense).
- The sharded step with "ring" on fsdp=2 x seq=2 x tensor=2 (the config
  of tests/test_multichip_hlo.py: TINY, 16 x 65 tokens, AdamW 1e-3,
  weight decay 0.01), with and without remat "full": 3 steps' losses
  (1e-5 relative), grad norms (1e-5) and final params (1e-4 relative
  norm) against the JAX step on the same mesh without remat (remat
  recomputes the same function; the port's recompute reruns the ring's
  exchanges on every rank alike).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _torch_sharded_workers as workers
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel import ring_attention as jring
from ray_tpu.parallel import ulysses_attention as julysses
from ray_tpu.parallel.train_step import make_train_step as jax_make_train_step

STEPS = workers.STEPS


def _inputs(seed, b, t, hq, hkv, d):
    rng = np.random.default_rng(seed)
    shapes = {"q": (b, t, hq, d), "k": (b, t, hkv, d), "v": (b, t, hkv, d),
              "do": (b, t, hq, d)}
    return {n: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for n, s in shapes.items()}


def _jax_attention(fn, sizes, inputs, causal, spec):
    """(o, dq, dk, dv) of fn under shard_map over a mesh of `sizes`."""
    mesh = jax_make_mesh(JMeshConfig(**sizes),
                         devices=jax.devices()[:8])
    sharded = shard_map(lambda q, k, v: fn(q, k, v, causal=causal),
                        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    q, k, v, do = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "do"))
    o, vjp = jax.vjp(jax.jit(sharded), q, k, v)
    dq, dk, dv = vjp(do)
    return {n: np.asarray(a) for n, a in
            (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))}


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _jax_step(params, batch):
    cfg = JTINY.replace(dtype="float32", attention_impl="ring")
    mesh = jax_make_mesh(JMeshConfig(data=1, fsdp=2, seq=2, tensor=2),
                         devices=jax.devices()[:8])
    init, step = jax_make_train_step(
        lambda p, b: JTransformer.loss(p, b, cfg, mesh=mesh),
        JTransformer.param_specs(cfg), mesh,
        optimizer=optax.adamw(1e-3, weight_decay=0.01))
    state = init(jax.tree.map(jnp.asarray, params))
    losses, gnorms = [], []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": gnorms,
            "params": _flat(jax.device_get(state["params"]))}


ATTENTION = {
    "ring causal=True": (jring, dict(data=1, seq=8), "ring", True,
                         P(None, "seq")),
    "ring causal=False": (jring, dict(data=1, seq=8), "ring", False,
                          P(None, "seq")),
    "ulysses": (julysses, dict(data=2, seq=4), "ulysses", True,
                P("data", "seq")),
    "ring gqa": (jring, dict(data=2, seq=4), "gqa", True, P("data", "seq")),
    "ulysses gqa": (julysses, dict(data=2, seq=4), "gqa", True,
                    P("data", "seq")),
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_parallel")
    jcfg = JTINY.replace(dtype="float32")
    params = jax.tree.map(np.asarray,
                          JTransformer.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(4)
    data = {"ring": _inputs(0, 2, 64, 4, 4, 16),
            "ulysses": _inputs(1, 2, 32, 8, 8, 16),
            "gqa": _inputs(2, 2, 256, 8, 2, 16),
            "params": params,
            "tokens": rng.integers(0, jcfg.vocab_size, (2, 32)),
            "batch": {"tokens": rng.integers(0, jcfg.vocab_size,
                                             (16, 65)).astype(np.int32)}}
    ranks = workers.start("seq_parallel", data, 8, str(tmp))
    ref = {name: _jax_attention(fn, sizes, data[key], causal, spec)
           for name, (fn, sizes, key, causal, spec) in ATTENTION.items()}
    ref["logits"] = np.asarray(JTransformer.apply(params, data["tokens"],
                                                  jcfg))
    ref["step"] = _jax_step(params, data["batch"])
    return ranks.result(timeout=120), ref


def _close_by_norm(got, want, tol, what):
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= tol, f"{what}: relative norm error {err:.3e}"


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_attention_matches_jax(run, case):
    got, ref = run
    np.testing.assert_allclose(got[case]["o"], ref[case]["o"], rtol=2e-4,
                               atol=2e-5)
    for g in ("dq", "dk", "dv"):
        _close_by_norm(got[case][g], ref[case][g], 1e-4, f"{case} {g}")


def test_ring_exchange_carries_kv_width(run):
    got, _ = run
    carried = got["ring gqa carried"]
    # forward: k, v on 3 hops; backward: k, v, dk, dv on 3, dk, dv home
    assert len(carried) == 2 * 3 + 4 * 3 + 2
    assert {s for s in carried} == {(1, 64, 2, 16)}


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_logits_over_seq_match_jax_dense(run, impl):
    got, ref = run
    np.testing.assert_allclose(got[f"logits {impl}"], ref["logits"],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_ring_step_fsdp_seq_tensor_matches_jax(run, remat):
    got, ref = run
    got = got[f"step remat={remat}"]
    np.testing.assert_allclose(got["loss"], ref["step"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["step"]["grad_norm"],
                               rtol=1e-5)
    for name, want in ref["step"]["params"].items():
        _close_by_norm(got["params"][name], want, 1e-4, name)
