"""The port's SAC, TD3 and DDPG against the JAX package's, on the CPU.

The JAX learners' params (and targets) go through params_from_jax into
the port's learners, and the same batches (numpy, from
np.random.default_rng) through both, f32 on device="cpu". Each loss's
noise is the JAX loss's own draw, reproduced with jax.random from the
same key split as the JAX loss splits it, and handed to the port's loss
(its noise argument, or its draw_noise inside an update). Bars: loss and
stats at rtol 1e-5, each grad at rtol 1e-5 with an atol of 1e-5 times
the largest grad element (PPO's bars, tests/test_torch_rllib_learner.py);
after updates, params, polyak targets and Adam's moments at rtol 1e-4
with an atol of 1e-4 times the learning rate for params and targets
(1e-4 times the largest moment for moments). chip_smoke.py's Pendulum
equals gymnasium's Pendulum-v1 bit for bit. SAC, TD3 and DDPG build and
train at the JAX package's compile-and-step settings, and save/restore
keeps their targets.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.rllib.algorithms.ddpg.ddpg import DDPGConfig as JDDPGConfig
from ray_tpu.rllib.algorithms.sac.sac import SACConfig as JSACConfig
from ray_tpu.rllib.algorithms.sac.sac import SACLearner as JSACLearner
from ray_tpu.rllib.algorithms.sac.sac import \
    SquashedGaussianModule as JSquashed
from ray_tpu.rllib.algorithms.td3.td3 import \
    DeterministicModule as JDeterministic
from ray_tpu.rllib.algorithms.td3.td3 import TD3Config as JTD3Config
from ray_tpu.rllib.algorithms.td3.td3 import TD3Learner as JTD3Learner
from ray_tpu_torch.rllib import (DDPGConfig, SACConfig, TD3Config,
                                 params_from_jax)
from ray_tpu_torch.rllib.algorithms.sac.sac import (SACLearner,
                                                    SquashedGaussianModule)
from ray_tpu_torch.rllib.algorithms.td3.td3 import (DeterministicModule,
                                                    TD3Learner)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

OBS, ACT, HIDDENS = 3, 2, (32, 32)
LOW, HIGH = [-2.0, -1.0], [2.0, 3.0]


def test_chip_smoke_pendulum_equals_gymnasium():
    """200 random-action steps from one seed: observations, rewards and
    flags to the bit, truncation at step 200, then a reset."""
    import gymnasium
    ours, theirs = chip_smoke.Pendulum(), gymnasium.make("Pendulum-v1")
    try:
        assert ours.observation_space.shape == (3,)
        np.testing.assert_array_equal(ours.action_space.high, [2.0])
        o1, _ = ours.reset(11)
        o2, _ = theirs.reset(seed=11)
        np.testing.assert_array_equal(o1, o2)
        rng = np.random.default_rng(0)
        for i in range(200):
            a = rng.uniform(-2.5, 2.5, 1).astype(np.float32)
            got, want = ours.step(a), theirs.step(a)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1] and got[2:4] == want[2:4], i
        assert got[3] is True
        np.testing.assert_array_equal(ours.reset(12)[0],
                                      theirs.reset(seed=12)[0])
    finally:
        theirs.close()


def _batch(n, seed, weights=False):
    rng = np.random.default_rng(seed)
    b = {"obs": rng.standard_normal((n, OBS)).astype(np.float32),
         "actions": rng.uniform(LOW, HIGH, (n, ACT)).astype(np.float32),
         "rewards": rng.standard_normal(n).astype(np.float32),
         "dones": (rng.random(n) < 0.2).astype(np.float32),
         "discounts": np.full(n, 0.99, np.float32),
         "next_obs": rng.standard_normal((n, OBS)).astype(np.float32),
         "batch_indexes": np.arange(n, dtype=np.int64)}
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _learners(kind, **training):
    if kind == "sac":
        jcfg, cfg = JSACConfig(), SACConfig()
        jmod = JSquashed(OBS, ACT, LOW, HIGH, HIDDENS)
        mod = SquashedGaussianModule(OBS, ACT, LOW, HIGH, HIDDENS)
        jcls, cls = JSACLearner, SACLearner
    else:
        jcfg = JDDPGConfig() if kind == "ddpg" else JTD3Config()
        cfg = DDPGConfig() if kind == "ddpg" else TD3Config()
        jmod = JDeterministic(OBS, ACT, LOW, HIGH, HIDDENS)
        mod = DeterministicModule(OBS, ACT, LOW, HIGH, HIDDENS)
        jcls, cls = JTD3Learner, TD3Learner
    jl = jcls(jmod, jcfg.training(**training))
    jl.build(seed=3)
    tl = cls(mod, cfg.training(**training).learners(device="cpu"))
    tl.build(seed=0)
    tl.module.load_state_dict(params_from_jax(tl.module,
                                              jax.device_get(jl._params)))
    tl._target.load_state_dict(params_from_jax(tl._target,
                                               jax.device_get(jl._target)))
    return jl, tl


def _loss_key(jl):
    """The key the JAX learner's next extra_inputs() hands its loss."""
    return jax.random.split(jl._rng)[1]


def _noise(kind, key, n):
    """The JAX loss's draws from `key` as numpy: SAC's two (sac.py:178,
    :85), TD3's smoothing draw (td3.py:141)."""
    if kind == "sac":
        k_next, k_pi = jax.random.split(key)
        return tuple(np.array(jax.random.normal(k, (n, ACT)))
                     for k in (k_next, k_pi))
    return np.array(jax.random.normal(key, (n, ACT)))


def _to_noise(kind, noise):
    if kind == "sac":
        return tuple(torch.from_numpy(x) for x in noise)
    return torch.from_numpy(noise)


def _assert_tree(tl_module, got, jax_tree, scale_atol, err=""):
    want = params_from_jax(tl_module, jax.device_get(jax_tree))
    for name, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=scale_atol,
                                   err_msg=f"{err}{name}")


def _adam_moments(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]


def test_squashed_sample_matches_jax():
    """The reparameterised tanh-squashed sample and its log-prob from the
    same params and the same standard-normal draw."""
    jmod = JSquashed(OBS, ACT, LOW, HIGH, HIDDENS)
    mod = SquashedGaussianModule(OBS, ACT, LOW, HIGH, HIDDENS)
    params = jax.device_get(jmod.init_params(jax.random.PRNGKey(1)))
    params["log_alpha"] = np.zeros((), np.float32)
    mod.load_state_dict(params_from_jax(mod, params))
    obs = np.random.default_rng(2).standard_normal((64, OBS)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    ja, jlogp = jmod.sample_action(params, jnp.asarray(obs), key)
    noise = np.array(jax.random.normal(key, (64, ACT)))
    a, logp = mod.sample_action(torch.from_numpy(obs),
                                torch.from_numpy(noise))
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(jlogp),
                               rtol=1e-5, atol=1e-5)
    assert np.all(a.detach().numpy() >= LOW) and \
        np.all(a.detach().numpy() <= HIGH)
    inf = mod.forward_inference({"obs": torch.from_numpy(obs)})["actions"]
    np.testing.assert_allclose(
        inf.detach().numpy(),
        np.asarray(jmod.forward_inference(params, {"obs": obs})["actions"]),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,weights", [("sac", False), ("sac", True),
                                          ("td3", False), ("td3", True),
                                          ("ddpg", False)])
def test_loss_and_grads_match_jax(kind, weights):
    jl, tl = _learners(kind)
    batch = _batch(40, seed=4, weights=weights)
    key = jax.random.PRNGKey(21)
    jextra = {"target": jl._target, "rng": key}
    if kind != "sac":
        jextra["policy_gate"] = jnp.asarray(1.0, jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jstats), jgrads = jax.value_and_grad(
        lambda p: jl.compute_loss(p, jb, jextra), has_aux=True)(jl._params)
    extra = tl.extra_inputs()
    extra["policy_gate"] = 1.0
    loss, stats = tl.compute_loss(_torch(batch), extra,
                                  _to_noise(kind, _noise(kind, key, 40)))
    grads = torch.autograd.grad(loss, list(tl.module.parameters()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want = params_from_jax(tl.module, jax.device_get(jgrads))
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for (name, _), g in zip(tl.module.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_sac_updates_and_polyak_targets_match_jax():
    """Three Learner.updates, each followed by the polyak step, from the
    JAX learner's own noise: params (log_alpha among them) and the q1/q2
    targets."""
    lr = 3e-4
    jl, tl = _learners("sac", lr=lr, tau=0.05)
    for i in range(3):
        batch = _batch(32, seed=30 + i)
        noise = _to_noise("sac", _noise("sac", _loss_key(jl), 32))
        tl.draw_noise = lambda b, g, noise=noise: noise
        want = jl.update(batch, minibatch_size=None, num_iters=1, seed=i)
        got = tl.update(batch, minibatch_size=None, num_iters=1, seed=i)
        for k in ("critic_loss", "actor_loss", "alpha_loss", "alpha",
                  "total_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
        jl.additional_update(polyak=True)
        tl.additional_update(polyak=True)
    _assert_tree(tl.module, dict(tl.module.named_parameters()), jl._params,
                 1e-4 * lr)
    _assert_tree(tl._target, dict(tl._target.named_parameters()),
                 jl._target, 1e-4 * lr, "target ")
    assert tl.module.log_alpha.item() != 0.0  # alpha moved off 1.0


def test_td3_policy_delay_gates_pi_and_moments_match_jax():
    """Four updates at policy_delay 2: on the gated updates (1 and 3) pi
    stays exactly as it was while its Adam moments advance (decay), as
    the JAX package's do; params, targets and moments match it."""
    lr = 1e-3
    jl, tl = _learners("td3", lr=lr, tau=0.05)
    for i in range(4):
        batch = _batch(32, seed=50 + i)
        noise = _to_noise("td3", _noise("td3", _loss_key(jl), 32))
        tl.draw_noise = lambda b, g, noise=noise: noise
        pi_before = {k: v.clone() for k, v in tl.module.state_dict().items()
                     if k.startswith("pi.")}
        mu_before = {k: tl._optimizer.state[p]["exp_avg"].clone()
                     for k, p in tl.module.named_parameters()
                     if k.startswith("pi.") and p in tl._optimizer.state}
        jl.update(batch, minibatch_size=None, num_iters=1, seed=i)
        got = tl.update(batch, minibatch_size=None, num_iters=1, seed=i)
        assert np.isfinite(got["critic_loss"])
        gated = i % 2 == 0
        pi_after = {k: v for k, v in tl.module.state_dict().items()
                    if k.startswith("pi.")}
        assert all(torch.equal(pi_before[k], v)
                   for k, v in pi_after.items()) == gated
        if gated and mu_before:
            for k, p in tl.module.named_parameters():
                if k.startswith("pi."):
                    np.testing.assert_allclose(
                        tl._optimizer.state[p]["exp_avg"].numpy(),
                        0.9 * mu_before[k].numpy(), rtol=1e-6, atol=1e-12)
        jl.additional_update(polyak=True)
        tl.additional_update(polyak=True)
        _assert_tree(tl.module, dict(tl.module.named_parameters()),
                     jl._params, 1e-4 * lr, f"update {i + 1} ")
    _assert_tree(tl._target, dict(tl._target.named_parameters()),
                 jl._target, 1e-4 * lr, "target ")
    adam = _adam_moments(jl._opt_state)
    for attr, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = params_from_jax(tl.module, jax.device_get(getattr(adam, attr)))
        scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
        for name, p in tl.module.named_parameters():
            np.testing.assert_allclose(
                tl._optimizer.state[p][slot].numpy(), want[name].numpy(),
                rtol=1e-4, atol=1e-4 * scale, err_msg=f"{slot} {name}")
    assert tl.get_state()["updates"] == 4


# ---- algorithms ----------------------------------------------------------

STEP = dict(buffer_size=2000, train_batch_size=32, training_intensity=2.0,
            num_steps_sampled_before_learning_starts=32)


@pytest.mark.parametrize("config_cls", [SACConfig, TD3Config, DDPGConfig],
                         ids=lambda c: c.__name__)
def test_builds_and_trains(config_cls):
    """The JAX package's compile-and-step settings (tests/test_rllib_sac.py,
    tests/test_rllib_pg_td3.py): Pendulum-v1, 2 envs at fragment 8,
    (32, 32), 3 iterations; the runner's actions are float and in range."""
    algo = (config_cls().environment("Pendulum-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                         rollout_fragment_length=8)
            .training(**STEP).rl_module(model_hiddens=(32, 32))
            .learners(device="cpu").debugging(seed=0).build())
    try:
        for _ in range(3):
            result = algo.train()
        assert result["replay_buffer_size"] > 0
        assert np.isfinite(result["learner"]["critic_loss"])
        if config_cls is SACConfig:
            assert "alpha" in result["learner"]
        else:
            assert result["learner"]["exploration_noise"] == 0.1
        actions = algo.replay_buffer._cols["actions"][:len(
            algo.replay_buffer)]
        assert actions.dtype == np.float32 and actions.shape[1:] == (1,)
        assert np.all(np.abs(actions) <= 2.0) and np.unique(actions).size > 10
    finally:
        algo.stop()


@pytest.mark.parametrize("config_cls", [SACConfig, TD3Config],
                         ids=lambda c: c.__name__)
def test_save_restore_keeps_targets(config_cls, tmp_path):
    cfg = (config_cls().environment("Pendulum-v1")
           .training(buffer_size=500, train_batch_size=16,
                     training_intensity=1.0,
                     num_steps_sampled_before_learning_starts=16)
           .rl_module(model_hiddens=(16,)).learners(device="cpu"))
    algo = cfg.copy().debugging(seed=0).build()
    algo2 = cfg.copy().debugging(seed=9).build()
    try:
        for _ in range(20):
            algo.train()
        algo.save(str(tmp_path / "ckpt"))
        algo2.restore(str(tmp_path / "ckpt"))
        s, s2 = algo.learner_group.get_state(), \
            algo2.learner_group.get_state()
        for part in ("params", "target"):
            assert set(s[part]) == set(s2[part])
            for k, v in s[part].items():
                np.testing.assert_array_equal(s2[part][k], v)
        # polyak targets trail the params
        assert any(not np.array_equal(s["params"][k], v)
                   for k, v in s["target"].items())
        if config_cls is TD3Config:
            assert s2["updates"] == s["updates"] > 0
    finally:
        algo.stop()
        algo2.stop()
