"""The port's vocab-parallel embedding, head and cross-entropy on 4 gloo
ranks (fsdp=2 x tensor=2) against the JAX package's Transformer.loss and
jax.grad on the CPU.

The JAX rules shard `embed` as ("vocab", "embed") and `lm_head` as
("embed", "vocab") with "vocab" on `tensor`. One spawn of 4 ranks
(tests/_torch_sharded_workers.py, job "vocab_parallel") runs TINY (f32,
vocab 256: 128 a tensor rank) from the JAX package's Transformer.init
params, for tied and untied embeddings, with the loss chunked
(loss_chunk 8 of 32 positions) and not: 3 AdamW steps (lr 1e-3, weight
decay 0.01) of make_train_step on a 4 x 33 batch. JAX runs the same steps
on one device: jax.value_and_grad of Transformer.loss over the global
batch, then optax.adamw. Loss and grad norm per step agree to rtol 1e-4,
the first step's grads to rtol 1e-4 of each param's grad norm, the final
params to rtol 1e-4, atol 1e-5: the bars of
tests/test_torch_sharded_step.py, with its rule for Adam: an element
whose grads are f32 rounding (one of wkv's in the tied case: 4.7e-9
here, 3.0e-9 in JAX, against a largest grad of 1.7e-2) takes an update
of up to lr a step in either, so at most 1e-4 of the elements fall
outside those bars, each within 2 lr a step. Every head the loss
multiplies by is [d, vocab / 2] on every rank, never the whole [d,
vocab]. forward's logits come out whole over the vocab and equal JAX's
apply.
"""

import numpy as np
import pytest

import jax
import optax

import _torch_sharded_workers as workers
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer

STEPS = workers.STEPS
LR = 1e-3
CASES = {"untied": (False, 0), "untied chunked": (False, 8),
         "tied": (True, 0), "tied chunked": (True, 8)}


def _jcfg(case):
    tie, chunk = CASES[case]
    return JTINY.replace(dtype="float32", tie_embeddings=tie,
                         loss_chunk=chunk)


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _jax_run(params, batch, jcfg):
    """(losses, grad norms, the first step's grads, final params)."""
    opt = optax.adamw(LR, weight_decay=0.01)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda q: JTransformer.loss(q, batch, jcfg))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, optax.global_norm(g), g

    p = jax.tree.map(jax.numpy.asarray, params)
    s = opt.init(p)
    losses, gnorms, first = [], [], None
    for _ in range(STEPS):
        p, s, loss, gnorm, g = step(p, s)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        first = first or _flat(jax.device_get(g))
    return losses, gnorms, first, _flat(jax.device_get(p))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(rank 0's results, the JAX references, the batch), the JAX steps
    run while the ranks do."""
    tmp = tmp_path_factory.mktemp("vocab_parallel")
    params = {case: jax.tree.map(np.asarray, JTransformer.init(
        jax.random.PRNGKey(0), _jcfg(case))) for case in CASES}
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, JTINY.vocab_size, (4, 33)
                                    ).astype(np.int32)}
    ranks = workers.start("vocab_parallel", {
        "params": params, "batch": batch, "cases": CASES}, 4, str(tmp))
    ref = {case: _jax_run(params[case], batch, _jcfg(case))
           for case in CASES}
    ref["logits"] = np.asarray(JTransformer.apply(
        params["untied"], batch["tokens"][:, :-1], _jcfg("untied")))
    return ranks.result(timeout=240), ref


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grad_norm_match_jax(run, case):
    got, ref = run
    np.testing.assert_allclose(got[case]["loss"], ref[case][0], rtol=1e-4)
    np.testing.assert_allclose(got[case]["grad_norm"], ref[case][1],
                               rtol=1e-4)
    assert got[case]["loss"][-1] < got[case]["loss"][0]


@pytest.mark.parametrize("case", list(CASES))
def test_first_step_grads_match_jax(run, case):
    got, ref = run
    assert set(got[case]["grads"]) == set(ref[case][2])
    for name, want in ref[case][2].items():
        err = np.linalg.norm(got[case]["grads"][name] - want)
        assert err <= 1e-4 * np.linalg.norm(want), (name, err)


@pytest.mark.parametrize("case", list(CASES))
def test_final_params_match_jax(run, case):
    got, ref = run
    outside, total = 0, 0
    for name, want in ref[case][3].items():
        a = got[case]["params"][name]
        off = np.abs(a - want) > 1e-5 + 1e-4 * np.abs(want)
        outside, total = outside + int(off.sum()), total + a.size
        assert np.abs(a - want).max() <= 2 * LR * STEPS, name
    assert outside <= 1e-4 * total, outside


@pytest.mark.parametrize("case", list(CASES))
def test_no_rank_multiplies_by_the_whole_head(run, case):
    """The loss's only products with a vocab-wide dim are with this
    rank's half of the head: [d, vocab / 2], once a step unchunked and
    once a chunk (and its recompute) chunked."""
    got, _ = run
    d, vocab = JTINY.d_model, JTINY.vocab_size
    widths = got[case]["head_widths"]
    assert (d, vocab) not in widths
    chunks = 32 // CASES[case][1] if CASES[case][1] else 1
    assert widths.count((d, vocab // 2)) == 2 * chunks if chunks > 1 \
        else widths.count((d, vocab // 2)) == 1, widths


def test_forward_logits_whole_over_the_vocab(run):
    got, ref = run
    assert got["logits"].shape == ref["logits"].shape == (4, 32, 256)
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-4,
                               atol=1e-5)
