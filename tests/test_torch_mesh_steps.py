"""The port's train steps on the meshes of the JAX package's multi-slice
test, on 8 gloo ranks against the JAX make_train_step on the 8-device
virtual mesh, on the CPU.

The mesh is 2 x (data=2 x tensor=2) (tests/test_multislice.py:59-85).
One spawn of 8 ranks (tests/_torch_sharded_workers.py, job
"mesh_steps") runs TINY (f32) from the JAX package's Transformer.init
params, 3 AdamW steps (lr 1e-3, weight decay 0.01) on an 8 x 33 batch:
- the replicated-params step (param_specs None): the batch's rows split
  over dcn x data, the tensor ranks sharing rows, the grads summed over
  the data axes; JAX's step takes all-replicated specs on the same mesh;
- the sharded step with the rules' "batch" on ("dcn", "data", "fsdp"),
  the params placed by Transformer.param_specs (heads, mlp and vocab over
  tensor); JAX's step and loss take the same rules on the same mesh.
Loss and grad norm per step agree to rtol 1e-4 and the final params to
rtol 1e-4, atol 1e-5 (the bars of tests/test_torch_sharded_step.py, with
its rule for Adam's near-zero grads: at most 1e-4 of the elements
outside, each within 2 lr a step).
"""

import numpy as np
import pytest

import jax
import optax

import _torch_sharded_workers as workers
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import MultiSliceConfig as JMultiSliceConfig
from ray_tpu.parallel import ShardingRules as JShardingRules
from ray_tpu.parallel import make_multislice_mesh as jax_multislice_mesh
from ray_tpu.parallel.train_step import make_train_step as jax_make_train_step

STEPS = workers.STEPS
LR = 1e-3
JCFG = JTINY.replace(dtype="float32")


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _replicated(specs):
    if isinstance(specs, tuple):
        return (None,) * len(specs)
    return {k: _replicated(v) for k, v in specs.items()}


def _jax_run(params, batch, case):
    mesh = jax_multislice_mesh(JMultiSliceConfig(
        num_slices=2, per_slice=JMeshConfig(data=2, tensor=2)))
    specs = JTransformer.param_specs(JCFG)
    if case == "replicated":
        rules = JShardingRules()
        loss, specs = (lambda p, b: JTransformer.loss(p, b, JCFG),
                       _replicated(specs))
    else:
        rules = JShardingRules().replace(batch=("dcn", "data", "fsdp"))
        loss = (lambda p, b: JTransformer.loss(p, b, JCFG, mesh=mesh,
                                               rules=rules))
    init, step = jax_make_train_step(
        loss, specs, mesh, rules=rules,
        optimizer=optax.adamw(LR, weight_decay=0.01))
    state = init(jax.tree.map(jax.numpy.asarray, params))
    losses, gnorms = [], []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms, _flat(jax.device_get(state["params"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    params = jax.tree.map(np.asarray,
                          JTransformer.init(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, JCFG.vocab_size, (8, 33)
                                    ).astype(np.int32)}
    ranks = workers.start("mesh_steps", {"params": params, "batch": batch},
                          8, str(tmp_path_factory.mktemp("mesh_steps")))
    ref = {case: _jax_run(params, batch, case)
           for case in ("replicated", "dcn")}
    return ranks.result(timeout=240), ref


@pytest.mark.parametrize("case", ["replicated", "dcn"])
def test_loss_and_grad_norm_match_jax(run, case):
    got, ref = run
    np.testing.assert_allclose(got[case]["loss"], ref[case][0], rtol=1e-4)
    np.testing.assert_allclose(got[case]["grad_norm"], ref[case][1],
                               rtol=1e-4)
    assert got[case]["loss"][-1] < got[case]["loss"][0]


@pytest.mark.parametrize("case", ["replicated", "dcn"])
def test_final_params_match_jax(run, case):
    got, ref = run
    assert set(got[case]["params"]) == set(ref[case][2])
    outside, total = 0, 0
    for name, want in ref[case][2].items():
        a = got[case]["params"][name]
        off = np.abs(a - want) > 1e-5 + 1e-4 * np.abs(want)
        outside, total = outside + int(off.sum()), total + a.size
        assert np.abs(a - want).max() <= 2 * LR * STEPS, name
    assert outside <= 1e-4 * total, outside
