"""The port's ES, flat parameter order and exploration noise against the
JAX package's, on the CPU.

Bit for bit: compute_centered_ranks; flat_order's vector against
ravel_pytree's of the same params (the MLP, the Nature CNN, SAC's module
with its log_alpha leaf, a multi-agent tree) and back; the
Ornstein-Uhlenbeck process; ParameterNoise.perturb from one seed, taken
through params_from_jax. The host Adam against optax.adam over five
steps (rtol 1e-6: f32 either way, optax's bias correction computed by
XLA). One ES training_step from the same converted weights and seed, 4
perturbations over a horizon of 50: the same returns and the same theta
(rtol 1e-5); the learner's weights are theta unflattened; save/restore
keeps theta and its Adam state; two remote evaluation workers give the
local worker's returns.
"""

import functools

import numpy as np
import pytest

import jax
import optax
import torch
from jax.flatten_util import ravel_pytree

import ray_tpu_torch
from ray_tpu.rllib.algorithms.es.es import ESConfig as JESConfig
from ray_tpu.rllib.algorithms.es.es import \
    compute_centered_ranks as jax_ranks
from ray_tpu.rllib.algorithms.sac.sac import \
    SquashedGaussianModule as JSquashed
from ray_tpu.rllib.core.catalog import DiscreteConvModule as JConv
from ray_tpu.rllib.core.catalog import DiscreteMLPModule as JMLP
from ray_tpu.rllib.utils.exploration import \
    OrnsteinUhlenbeckNoise as JOU
from ray_tpu.rllib.utils.exploration import ParameterNoise as JParamNoise
from ray_tpu_torch.rllib import (DiscreteConvModule, DiscreteMLPModule,
                                 ESConfig, MultiAgentRLModule, flat_order,
                                 params_from_jax)
from ray_tpu_torch.rllib.algorithms.es.es import (adam_init, adam_update,
                                                  compute_centered_ranks)
from ray_tpu_torch.rllib.algorithms.sac.sac import SquashedGaussianModule
from ray_tpu_torch.rllib.utils.exploration import (OrnsteinUhlenbeckNoise,
                                                   ParameterNoise)


def test_centered_ranks_equal_jax():
    rng = np.random.default_rng(0)
    for x in (np.array([10.0, 30.0, 20.0]), rng.standard_normal((24, 2)),
              rng.integers(0, 5, (16, 2)).astype(np.float64)):  # ties
        np.testing.assert_array_equal(compute_centered_ranks(x),
                                      jax_ranks(x))


@functools.lru_cache(maxsize=None)
def _trees():
    """(port module, JAX params tree) pairs, the JAX params from a
    PRNG key (SAC's tree with the log_alpha its learner adds)."""
    key = jax.random.PRNGKey(4)
    sac = jax.device_get(JSquashed(3, 2, [-1.0, -2.0], [1.0, 2.0],
                                   (12, 12)).init_params(key))
    sac["log_alpha"] = np.asarray(0.25, np.float32)
    multi = {"pol_b": jax.device_get(JMLP(4, 2, (8,)).init_params(key)),
             "pol_a": jax.device_get(JMLP(4, 2, (8,)).init_params(
                 jax.random.PRNGKey(5)))}
    return [
        (DiscreteMLPModule(4, 2, (32, 32)),
         jax.device_get(JMLP(4, 2, (32, 32)).init_params(key))),
        (DiscreteConvModule((84, 84, 4), 3, dense=16),
         jax.device_get(JConv((84, 84, 4), 3, dense=16).init_params(key))),
        (SquashedGaussianModule(3, 2, [-1.0, -2.0], [1.0, 2.0], (12, 12)),
         sac),
        (MultiAgentRLModule({"pol_a": DiscreteMLPModule(4, 2, (8,)),
                             "pol_b": DiscreteMLPModule(4, 2, (8,))}),
         multi)]


@pytest.mark.parametrize("case", range(4), ids=["mlp", "cnn", "sac", "multi"])
def test_flat_order_equals_ravel_pytree(case):
    module, tree = _trees()[case]
    state = params_from_jax(module, tree)
    order = flat_order(module)
    got = order.flatten(state)
    want = np.asarray(ravel_pytree(tree)[0])
    assert got.dtype == np.float32 and order.dim == want.size
    np.testing.assert_array_equal(got, want)
    back = order.unflatten(got)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v.numpy())
    module.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()})


def test_ou_noise_equals_jax():
    ours, theirs = (OrnsteinUhlenbeckNoise((4, 2), theta=0.15, sigma=0.2,
                                           seed=1),
                    JOU((4, 2), theta=0.15, sigma=0.2, seed=1))
    for i in range(50):
        np.testing.assert_array_equal(ours.sample(), theirs.sample())
        if i == 20:
            ours.reset(lanes=[0])
            theirs.reset(lanes=[0])
    ours.reset()
    theirs.reset()
    np.testing.assert_array_equal(ours.sample(), theirs.sample())


@pytest.mark.parametrize("case", range(4), ids=["mlp", "cnn", "sac", "multi"])
def test_parameter_noise_perturbs_the_same_weights(case):
    """The port's perturb of the converted params equals the conversion
    of the JAX package's perturb of the tree, from one seed; sigma
    adapts the same way."""
    module, tree = _trees()[case]
    ours = ParameterNoise(initial_sigma=0.1, seed=3)
    theirs = JParamNoise(initial_sigma=0.1, seed=3)
    got = ours.perturb(params_from_jax(module, tree), module)
    want = params_from_jax(module, jax.device_get(theirs.perturb(tree)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    for clean, pert in ((np.zeros(8), np.full(8, 1.0)),
                        (np.zeros(8), np.full(8, 0.001))):
        assert ours.adapt(clean, pert) == theirs.adapt(clean, pert)
    assert ours.get_state() == theirs.get_state()


def test_host_adam_equals_optax():
    rng = np.random.default_rng(0)
    theta = rng.standard_normal(300).astype(np.float32)
    opt = optax.adam(0.03)
    jstate, state = opt.init(theta), adam_init(theta)
    jtheta = theta.copy()
    for _ in range(5):
        step = rng.standard_normal(300).astype(np.float32)
        jup, jstate = opt.update(step, jstate)
        up, state = adam_update(step, state, 0.03)
        np.testing.assert_allclose(up, np.asarray(jup), rtol=1e-6,
                                   atol=1e-9)
        jtheta = np.asarray(jtheta + jup, np.float32)
        theta = np.asarray(theta + up, np.float32)
    np.testing.assert_allclose(theta, jtheta, rtol=1e-6)
    np.testing.assert_allclose(state["mu"], np.asarray(jstate[0].mu),
                               rtol=1e-6)
    assert state["count"] == int(jstate[0].count) == 5


def test_config_defaults_match_jax():
    want, got = vars(JESConfig()), vars(ESConfig())
    assert set(got) - set(want) == {"learner_device"}
    for k, v in want.items():
        if k != "algo_class":
            assert got[k] == v, k


def _configs(**training):
    settings = dict(lr=0.03, sigma=0.1, num_perturbations=4,
                    episode_horizon=50, **training)
    return tuple(cls().environment("CartPole-v1").training(**settings)
                 .rl_module(model_hiddens=(32, 32)).debugging(seed=0)
                 for cls in (JESConfig, ESConfig))


def _learner_theta(algo):
    return algo._order.flatten(algo.learner_group.get_weights())


def test_one_training_step_matches_jax():
    jcfg, cfg = _configs()
    jalgo, algo = jcfg.build(), cfg.learners(device="cpu").build()
    try:
        state = params_from_jax(algo.module,
                                jalgo.learner_group.get_weights())
        algo.learner_group.set_weights(
            {k: v.numpy() for k, v in state.items()})
        algo._theta = algo._order.flatten(state)
        np.testing.assert_array_equal(algo._theta, jalgo._theta)
        want, got = jalgo.train(), algo.train()
        assert got["num_env_steps_sampled"] == \
            want["num_env_steps_sampled"]
        assert list(algo._episode_returns) == list(jalgo._episode_returns)
        assert got["learner"]["mean_perturbation_return"] == \
            want["learner"]["mean_perturbation_return"]
        np.testing.assert_allclose(algo._theta, jalgo._theta, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(_learner_theta(algo), algo._theta)
    finally:
        jalgo.stop()
        algo.stop()


def test_save_restore_keeps_theta_and_adam(tmp_path):
    _, cfg = _configs()
    algo = cfg.copy().learners(device="cpu").build()
    other = cfg.copy().learners(device="cpu").debugging(seed=7).build()
    try:
        for _ in range(2):
            algo.train()
        algo.save(str(tmp_path / "ckpt"))
        other.restore(str(tmp_path / "ckpt"))
        np.testing.assert_array_equal(other._theta, algo._theta)
        for k in ("mu", "nu"):
            np.testing.assert_array_equal(other._opt_state[k],
                                          algo._opt_state[k])
        assert other._opt_state["count"] == algo._opt_state["count"] == 2
        np.testing.assert_array_equal(_learner_theta(other), algo._theta)
        assert algo.env_runners is None
    finally:
        algo.stop()
        other.stop()


def test_remote_workers_give_the_local_returns():
    """num_workers=2 through ray_tpu_torch.remote: the workers split the
    seeds, and the returns (and so theta) equal the local evaluation's;
    stop() kills them."""
    _, cfg = _configs()
    local = cfg.copy().learners(device="cpu").build()
    ray_tpu_torch.init(num_cpus=3)
    try:
        remote = cfg.copy().training(num_workers=2).learners(
            device="cpu").build()
        try:
            want, got = local.train(), remote.train()
            assert got["num_env_steps_sampled"] == \
                want["num_env_steps_sampled"]
            assert sorted(remote._episode_returns) == \
                sorted(local._episode_returns)
            workers = list(remote._eval_workers)
            assert len(workers) == 2
        finally:
            remote.stop()
    finally:
        local.stop()
        ray_tpu_torch.shutdown()
