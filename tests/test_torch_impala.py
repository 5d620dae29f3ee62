"""The port's IMPALA and APPO pieces against the JAX package's, on the CPU.

V-trace, the IMPALA and APPO losses and grads, three learner updates,
the fragment concatenation, the host stage and the CPU route of the
device feed, the registry and the config defaults. Inputs come from
np.random.default_rng(seed), f32; the JAX package's params go through
params_from_jax into the port's modules; the learners are on
device="cpu". Tolerances: V-trace rtol 1e-6, atol 1e-6 (the same
elementwise ops in the same order, one f32 rounding apart at most where
the two libraries' exp differ); the losses at rtol 1e-5 and each grad at
rtol 1e-5 with an atol of 1e-5 times the largest grad element (PPO's
bars, tests/test_torch_rllib_learner.py); params after each of three
clipped Adam updates at rtol 1e-4 with an atol of 1e-4 times the
learning rate, and the lagged stats at rtol 1e-4 (the PPO sweep's bars);
concatenation and staging bit for bit.
"""

import queue

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.rllib.algorithms.appo.appo import APPOConfig as JAPPOConfig
from ray_tpu.rllib.algorithms.appo.appo import APPOLearner as JAPPOLearner
from ray_tpu.rllib.algorithms.impala import impala as jimpala
from ray_tpu.rllib.algorithms.impala.vtrace import \
    from_importance_weights as j_vtrace
from ray_tpu.rllib.core.catalog import DiscreteConvModule as JConv
from ray_tpu.rllib.core.catalog import DiscreteMLPModule as JMLP
from ray_tpu.rllib.utils import device_feed as jfeed
from ray_tpu_torch.rllib import (DiscreteConvModule, DiscreteMLPModule,
                                 get_algorithm_class, params_from_jax)
from ray_tpu_torch.rllib.algorithms.appo.appo import APPOConfig, APPOLearner
from ray_tpu_torch.rllib.algorithms.impala import impala
from ray_tpu_torch.rllib.algorithms.impala.vtrace import \
    from_importance_weights
from ray_tpu_torch.rllib.utils.device_feed import DeviceFeed, HostStage

OBS = (84, 84, 4)
ALGOS = {"impala": (jimpala.ImpalaLearner, jimpala.ImpalaConfig,
                    impala.ImpalaLearner, impala.ImpalaConfig),
         "appo": (JAPPOLearner, JAPPOConfig, APPOLearner, APPOConfig)}


def _vtrace_inputs(case):
    """tests/test_rllib.py:89's on-policy case (T 8, B 2, seed 1,
    discount 0.9), or an off-policy one: rho on both sides of 1, dones
    inside the sequence, clip thresholds 0.5 and 2.0."""
    rng = np.random.default_rng(1)
    t, b = 8, 2
    rewards = rng.normal(size=(t, b)).astype(np.float32)
    values = rng.normal(size=(t, b)).astype(np.float32)
    boot = rng.normal(size=(b,)).astype(np.float32)
    if case == "on_policy":
        return dict(log_rhos=np.zeros((t, b), np.float32),
                    discounts=np.full((t, b), 0.9, np.float32),
                    rewards=rewards, values=values, bootstrap_value=boot), {}
    log_rhos = rng.uniform(-1.5, 1.5, (t, b)).astype(np.float32)
    dones = np.zeros((t, b), bool)
    dones[2, 0] = dones[5, 1] = dones[6, 0] = True
    discounts = (0.99 * (1.0 - dones)).astype(np.float32)
    assert (np.exp(log_rhos) < 0.5).any() and (np.exp(log_rhos) > 2).any()
    return dict(log_rhos=log_rhos, discounts=discounts, rewards=rewards,
                values=values, bootstrap_value=boot), dict(
                    clip_rho_threshold=0.5, clip_pg_rho_threshold=2.0)


@pytest.mark.parametrize("case", ["on_policy", "off_policy"])
def test_vtrace_matches_jax(case):
    arrays, clips = _vtrace_inputs(case)
    want = j_vtrace(**{k: jnp.asarray(v) for k, v in arrays.items()},
                    **clips)
    got = from_importance_weights(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, **clips)
    for name in ("vs", "pg_advantages"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def _modules(kind):
    if kind == "mlp":
        jmod, mod = JMLP(4, 2, (32, 32)), DiscreteMLPModule(4, 2, (32, 32))
    else:
        jmod, mod = JConv(OBS, 3, dense=64), DiscreteConvModule(OBS, 3,
                                                                dense=64)
    params = jax.device_get(jax.jit(jmod.init_params)(jax.random.PRNGKey(3)))
    mod.load_state_dict(params_from_jax(mod, params))
    return jmod, params, mod


def _learners(algo, kind, **training):
    jcls, jcfg, tcls, tcfg = ALGOS[algo]
    jmod, params, mod = _modules(kind)
    jl = jcls(jmod, jcfg().training(**training))
    jl.build(seed=3)  # the same params as _modules' PRNGKey(3)
    tl = tcls(mod, tcfg().training(**training).learners(device="cpu"))
    tl.build(seed=0)
    tl.module.load_state_dict(params_from_jax(tl.module, params))
    return jl, tl


def _batch(kind, t, b, seed=0):
    """A time-major batch: behaviour logp scattered around the fresh
    policy's (so rho falls on both sides of 1 and the clips act), dones
    inside the sequences."""
    rng = np.random.default_rng(seed)
    n_act = 2 if kind == "mlp" else 3
    if kind == "mlp":
        obs = rng.standard_normal((t, b, 4)).astype(np.float32)
    else:
        obs = rng.integers(0, 256, (t, b, *OBS)).astype(np.uint8)
    return {
        "obs": obs,
        "actions": rng.integers(0, n_act, (t, b)).astype(np.int32),
        "rewards": rng.standard_normal((t, b)).astype(np.float32),
        "dones": rng.random((t, b)) < 0.2,
        "behaviour_logp": (np.log(1.0 / n_act)
                           + 0.5 * rng.standard_normal((t, b))).astype(
                               np.float32),
        "bootstrap_value": rng.standard_normal(b).astype(np.float32),
    }


@pytest.mark.parametrize("algo", ["impala", "appo"])
@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_loss_and_grads_match_jax(algo, kind):
    jl, tl = _learners(algo, kind)
    batch = _batch("mlp", 16, 4) if kind == "mlp" else _batch("cnn", 4, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jl.compute_loss(p, jb, jl.extra_inputs()),
        has_aux=True))(jl._params)
    loss, stats = tl.compute_loss(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        tl.extra_inputs())
    grads = torch.autograd.grad(loss, list(tl.module.parameters()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(stats) == set(jstats)
    if algo == "appo":
        assert "mean_ratio" in stats
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k].item(), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = params_from_jax(tl.module, jax.device_get(jgrads))
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for (name, _), g in zip(tl.module.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_three_clipped_updates_match_jax_with_lagged_stats():
    """Three full-batch updates on three batches, with a grad clip well
    under the grad norm, so optax's clip_by_global_norm fires on each:
    the params after each call, and the stats each call returns (the
    previous update's; the first call's own) as the JAX learner's."""
    lr = 1e-2
    jl, tl = _learners("impala", "mlp", lr=lr, grad_clip=0.1)
    losses = []  # each update's loss, taken at the params it starts from
    for i in range(3):
        batch = _batch("mlp", 16, 4, seed=10 + i)
        with torch.no_grad():
            losses.append(tl.compute_loss(
                {k: torch.from_numpy(v) for k, v in batch.items()},
                {})[0].item())
        want, got = jl.update(batch), tl.update(batch)
        np.testing.assert_allclose(got["total_loss"], losses[max(0, i - 1)],
                                   rtol=1e-6)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"call {i}: {k}")
        assert want["grad_norm"] > 4 * 0.1  # the clip fired
        params = params_from_jax(tl.module, jl.get_weights())
        for name, p in tl.module.state_dict().items():
            np.testing.assert_allclose(p.numpy(), params[name].numpy(),
                                       rtol=1e-4, atol=1e-4 * lr,
                                       err_msg=f"call {i}: {name}")
    assert len(set(losses)) == 3


def _fragments(rng, t=5, sizes=(3, 2, 4)):
    """Runner-like time-major fragments with mixed dtypes: uint8 frames,
    int64 actions, bool dones, f32 rewards, a [B] f32 bootstrap."""
    return [{
        "obs": rng.integers(0, 256, (t, b, 6, 6, 2)).astype(np.uint8),
        "actions": rng.integers(0, 3, (t, b)).astype(np.int64),
        "rewards": rng.standard_normal((t, b)).astype(np.float32),
        "dones": rng.random((t, b)) < 0.3,
        "behaviour_logp": rng.standard_normal((t, b)).astype(np.float32),
        "bootstrap_value": rng.standard_normal(b).astype(np.float32),
    } for b in sizes]


def test_concat_and_host_stage_match_jax_bit_for_bit():
    frags = _fragments(np.random.default_rng(0))
    want = jimpala._concat_fragments(frags)
    got = impala._concat_fragments(frags)
    jstaged = jfeed.HostStage(slots=2).assemble(
        frags, jimpala._batch_axis).as_dict()
    staged = HostStage(2, "cpu").assemble(frags, impala._batch_axis)
    assert staged.layout == jfeed.HostStage(slots=2).assemble(
        frags, jimpala._batch_axis).layout
    cols = {k: staged.segments[dt][off:off + n].view(shape)
            for k, (dt, off, n, shape) in staged.layout.items()}
    for k in want:
        for other in (got[k], jstaged[k], cols[k].numpy()):
            assert other.dtype == want[k].dtype and \
                other.shape == want[k].shape, k
            assert np.array_equal(other, want[k]), k


def test_device_feed_cpu_route_returns_batches_unchanged():
    """A CPU learner's feed: plain host tensors, every batch equal to its
    fragments' concatenation after its slot was reused, the slot pool
    bounded, and the JAX feed's stats keys."""
    rng = np.random.default_rng(1)
    host: queue.Queue = queue.Queue()
    stage = HostStage(2, "cpu")
    feed = DeviceFeed(host, "cpu")
    try:
        wants, gots = [], []
        for i in range(6):
            frags = _fragments(rng)
            wants.append(impala._concat_fragments(frags))
            host.put((stage.assemble(frags, impala._batch_axis), i))
            cols, meta = feed.get(timeout=30)
            assert meta == i
            gots.append(cols)
            # a segment per dtype (4) in each of the two slots, then
            # nothing more: the slots are reused
            assert stage.segments_allocated == 4 * min(i + 1, 2)
        for want, got in zip(wants, gots):
            assert set(got) == set(want)
            for k, v in want.items():
                assert got[k].device.type == "cpu"
                assert not got[k].is_pinned()
                np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert stage._free.qsize() == 2
        stats = feed.stats()
        assert stats["batches_fed"] == stats["fused_batches"] == 6
    finally:
        feed.stop()
    jax_feed = jfeed.DeviceFeed(queue.Queue())
    try:
        assert set(stats) == set(jax_feed.stats())
    finally:
        jax_feed.stop()


@pytest.mark.parametrize("name", ["IMPALA", "APPO"])
def test_config_defaults_match_jax(name):
    from ray_tpu.rllib import get_algorithm_class as j_get
    _, want = j_get(name, return_config=True)
    algo, got = get_algorithm_class(name, return_config=True)
    assert algo.__name__ == j_get(name).__name__
    w, g = vars(want), vars(got)
    # the port's config adds the learners' device and nothing else
    assert set(g) - set(w) == {"learner_device"} and set(w) <= set(g)
    for k in w:
        if k != "algo_class":
            assert g[k] == w[k], k
