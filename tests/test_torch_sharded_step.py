"""The port's sharded train step on 4 gloo ranks against the JAX package's
on a 4-device virtual mesh, on the CPU.

One spawn of 4 ranks (tests/_torch_sharded_workers.py, job
"fsdp_tensor") runs TINY (f32; GQA: 4 heads, 2 kv heads) from the JAX
package's Transformer.init params, carried across by
params_from_jax(mesh=...) into a model built on the meta device, on an
fsdp=2 x tensor=2 mesh: 3 AdamW steps
(lr 1e-3, weight decay 0.01) on a 4 x 33 batch, once unmasked and once
with a loss mask whose rows' densities differ (so the two fsdp ranks'
rows weigh differently in the global masked mean). The JAX
make_train_step runs the same steps on a 4-device mesh of the same
shape, while the ranks run. Loss and grad norm per step agree to rtol
1e-4 and the final params to rtol 1e-4, atol 1e-5: the bars of
tests/test_torch_train_step.py (f32 sums in another order; Adam turns
the rounding of a near-zero grad into an update of up to lr, the reason
for the atol). With the mask, 3 of the ~120k elements of the final params
(one each of w_down, w_gateup and wq) fall outside those bars, by up to
4.8e-4 (CPU run): Adam's update of an element whose grads nearly cancel
over the steps turns the f32 rounding of its grad into an update of up
to lr a step, in JAX and the port alike. So the masked run holds at
most 1e-4 of the elements outside the bars, each to what Adam moves an
element in 3 steps (2 lr a step), and its first step's grads, where the
mask's per-rank weighting and the partial-sum reductions show, to 1e-5
of each param's grad norm against jax.grad of the global masked loss.

The same ranks check: local shards 1/(fsdp tensor) of each dividing
dim; grads and both Adam moments placed as their params; remat "full"
and "dots" give remat=False's grads; a tensor=4 mesh, which 2 kv heads
do not divide, widens k and v and takes JAX's steps (the unmasked run's
on fsdp=2 x tensor=2, the same function); and a
sharded checkpoint (torch.distributed.checkpoint) reads back equal onto
the same mesh and onto fsdp=4; with_logical_constraint redistributes a
DTensor param to another logical spec.
"""

import numpy as np
import pytest

import jax
import optax
from torch.distributed.tensor import Replicate, Shard

import _torch_sharded_workers as workers
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel.sharding import logical_sharding as jax_logical_sharding
from ray_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ray_tpu_torch.models import Transformer
from ray_tpu_torch.parallel import MeshConfig, get_abstract_mesh
from ray_tpu_torch.parallel.sharding import flatten_specs, logical_sharding

STEPS = workers.STEPS
LR = 1e-3
MASK_DENSITY = (0.15, 0.3, 0.8, 1.0)


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _jax_run(params, batch, sizes):
    """(losses, grad norms, final params) of the JAX step on a mesh of
    `sizes`."""
    jcfg = JTINY.replace(dtype="float32")
    mesh = jax_make_mesh(JMeshConfig(**sizes), devices=jax.devices()[:4])
    init, step = jax_make_train_step(
        lambda p, b: JTransformer.loss(p, b, jcfg, mesh=mesh),
        JTransformer.param_specs(jcfg), mesh,
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
    """(rank 0's results, the JAX references), the JAX steps run while
    the ranks do."""
    tmp = tmp_path_factory.mktemp("sharded_step")
    jcfg = JTINY.replace(dtype="float32")
    params = jax.tree.map(np.asarray,
                          JTransformer.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 33)).astype(np.int32)
    mask = (rng.random((4, 32)) < np.array(MASK_DENSITY)[:, None]
            ).astype(np.float32)
    batches = {"unmasked": {"tokens": tokens},
               "masked": {"tokens": tokens, "mask": mask}}
    (tmp / "ckpt").mkdir()
    ranks = workers.start("fsdp_tensor", {
        "params": params, "batches": batches,
        "ckpt_dir": str(tmp / "ckpt")}, 4, str(tmp))
    ref = {name: _jax_run(params, batch, dict(data=1, fsdp=2, tensor=2))
           for name, batch in batches.items()}
    ref["masked_grads"] = _flat(jax.device_get(jax.jit(jax.grad(
        lambda p: JTransformer.loss(p, batches["masked"], jcfg)))(params)))
    # tensor=4 runs the unmasked steps, the JAX run's on fsdp=2 x tensor=2
    # being the same function
    ref["tensor4"] = ref["unmasked"]
    return ranks.result(timeout=240), ref


@pytest.mark.parametrize("case", ["unmasked", "masked", "tensor4"])
def test_loss_and_grad_norm_match_jax(run, case):
    got, ref = run
    np.testing.assert_allclose(got[case]["loss"], ref[case][0], rtol=1e-4)
    np.testing.assert_allclose(got[case]["grad_norm"], ref[case][1],
                               rtol=1e-4)
    assert got[case]["loss"][-1] < got[case]["loss"][0]


@pytest.mark.parametrize("case", ["unmasked", "masked", "tensor4"])
def test_final_params_match_jax(run, case):
    got, ref = run
    outside, total = 0, 0
    for name, want in ref[case][2].items():
        a = got[case]["params"][name]
        off = np.abs(a - want) > 1e-5 + 1e-4 * np.abs(want)
        outside, total = outside + int(off.sum()), total + a.size
        assert np.abs(a - want).max() <= 2 * LR * STEPS, name
    assert outside <= (1e-4 * total if case == "masked" else 0), outside


def test_masked_first_step_grads_match_jax(run):
    got, ref = run
    for name, want in ref["masked_grads"].items():
        g = got["remat_grads"]["none"][name]
        err = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert err < 1e-5, (name, err)


def test_local_shards_split_the_dividing_dims(run):
    """Each rank holds 1/(fsdp tensor) of a param sharded over both axes:
    its local shape divides each dim by the sizes of the mesh axes the
    JAX spec puts there."""
    got, _ = run
    jcfg = JTINY.replace(dtype="float32")
    mesh = jax_make_mesh(JMeshConfig(data=1, fsdp=2, tensor=2),
                         devices=jax.devices()[:4])
    flat = flatten_specs(JTransformer.param_specs(jcfg))
    shapes = {n: a.shape for n, a in got["unmasked"]["params"].items()}
    quartered = 0
    for name, spec in flat.items():
        jspec = jax_logical_sharding(spec, mesh, shape=shapes[name]).spec
        want = tuple(
            n // int(np.prod([mesh.shape[a] for a in
                              (e if isinstance(e, tuple) else (e,))]))
            if e is not None else n
            for n, e in zip(shapes[name], tuple(jspec) + (None,) * 8))
        assert got["local_shapes"][name] == want, name
        quartered += np.prod(want) * 4 == np.prod(shapes[name])
    assert quartered >= 7, got["local_shapes"]


def test_grads_and_adam_moments_take_their_params_placements(run):
    got, _ = run
    sharded = 0
    for name, p in got["placements"].items():
        assert p["grad"] == p["exp_avg"] == p["exp_avg_sq"] == p["param"], \
            (name, p)
        sharded += any(isinstance(pl, Shard) for pl in p["param"])
    assert sharded == 7, got["placements"]


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_grads_of_no_remat(run, policy):
    got, _ = run
    grads = got["remat_grads"]
    for name, g in grads["none"].items():
        np.testing.assert_allclose(grads[policy][name], g, rtol=0, atol=1e-6,
                                   err_msg=name)


def test_with_logical_constraint_redistributes_a_dtensor(run):
    got, _ = run
    # (data, fsdp, tensor): vocab stays over tensor, embed leaves fsdp
    assert got["constrained"] == {
        "placements": (Replicate(), Replicate(), Shard(0)), "equal": True}


def test_tensor4_widens_the_kv_heads(run):
    got, _ = run
    assert got["tensor4"]["widen"]
    assert got["tensor4"]["wkv_placements"] == (Replicate(),) * 3


@pytest.mark.parametrize("onto", ["same mesh", "fsdp=4"])
def test_sharded_checkpoint_reads_back_equal(run, onto):
    got, _ = run
    ck = got["checkpoint"][onto]
    assert ck["fresh"]
    assert ck["max_abs_diff"] == 0.0
    if onto == "fsdp=4":
        mesh4 = get_abstract_mesh(MeshConfig(data=1, fsdp=4), 4)
        specs = flatten_specs(Transformer.param_specs(JTINY))
        for name, placements in ck["placements"].items():
            shape = got["unmasked"]["params"][name].shape
            want = logical_sharding(specs[name], mesh4, shape=shape)
            assert placements == want, name
