"""The port's off-policy stack (schedules, replay buffers, DQN, SimpleQ)
against the JAX package's, on the CPU.

Bit for bit: the schedules, both replay buffers (the same seed gives the
same samples and, after the same updates, the same priorities; states
cross between the packages), fragment_to_transitions (1-step, n-step,
truncation, termination). The JAX package's params go through
params_from_jax into the port's modules, and the same inputs (numpy,
from np.random.default_rng) through both, f32 on device="cpu": the
dueling Q forward at rtol 1e-5 with PPO's module-forward atol of 1e-5
(Q's terms sum to values near 0 that keep their terms' rounding), DQN's
loss, stats and td_error at rtol 1e-5, each grad at rtol 1e-5 with an
atol of 1e-5 times the largest grad element (PPO's bars,
tests/test_torch_rllib_learner.py); three Adam updates with a hard
target sync between them, params at rtol 1e-4 with an atol of 1e-4
times the learning rate. Every config default equals the JAX package's.
Each algorithm builds and trains at the JAX package's compile-and-step
settings, and save/restore keeps the targets.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.rllib.algorithms.ddpg.ddpg import DDPGConfig as JDDPGConfig
from ray_tpu.rllib.algorithms.dqn.dqn import DQNConfig as JDQNConfig
from ray_tpu.rllib.algorithms.dqn.dqn import DQNLearner as JDQNLearner
from ray_tpu.rllib.algorithms.dqn.dqn import \
    DuelingQMLPModule as JDuelingQ
from ray_tpu.rllib.algorithms.dqn.dqn import \
    fragment_to_transitions as j_fragment_to_transitions
from ray_tpu.rllib.algorithms.dqn.simple_q import \
    SimpleQConfig as JSimpleQConfig
from ray_tpu.rllib.algorithms.sac.sac import SACConfig as JSACConfig
from ray_tpu.rllib.algorithms.td3.td3 import TD3Config as JTD3Config
from ray_tpu.rllib.utils import replay_buffers as jrb
from ray_tpu.rllib.utils import schedules as jsched
from ray_tpu_torch.rllib import (DDPGConfig, DQNConfig, SACConfig,
                                 SimpleQConfig, TD3Config, params_from_jax)
from ray_tpu_torch.rllib.algorithms.dqn.dqn import (DQNLearner,
                                                    DuelingQMLPModule,
                                                    fragment_to_transitions)
from ray_tpu_torch.rllib.utils import replay_buffers as rb
from ray_tpu_torch.rllib.utils import schedules as sched

OBS, ACTIONS, HIDDENS = 4, 3, (32, 32)


# ---- schedules and buffers, bit for bit ------------------------------

def test_schedules_equal_jax():
    ts = np.arange(0, 30_000, 37)
    pairs = [
        (sched.ConstantSchedule(0.3), jsched.ConstantSchedule(0.3)),
        (sched.LinearSchedule(5000, 0.02, 1.0),
         jsched.LinearSchedule(5000, 0.02, 1.0)),
        (sched.PiecewiseSchedule([(0, 1.0), (1000, 0.5), (9000, 0.1)],
                                 outside_value=0.05),
         jsched.PiecewiseSchedule([(0, 1.0), (1000, 0.5), (9000, 0.1)],
                                  outside_value=0.05)),
        (sched.ExponentialSchedule(2000, initial_p=1.0, decay_rate=0.1),
         jsched.ExponentialSchedule(2000, initial_p=1.0, decay_rate=0.1)),
    ]
    for ours, theirs in pairs:
        assert [ours(t) for t in ts] == [theirs(t) for t in ts]


def _transitions(rng, n):
    return {"obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACTIONS, n).astype(np.int32),
            "rewards": rng.standard_normal(n).astype(np.float32)}


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffers_equal_jax(prioritized):
    """The same adds (wrapping the ring), samples, priority updates
    (stale tickets among them) and state round trips give the same
    columns, indexes, epochs, weights and priorities."""
    def make(mod, seed):
        if prioritized:
            return mod.PrioritizedReplayBuffer(64, alpha=0.6, seed=seed)
        return mod.ReplayBuffer(64, seed=seed)

    ours, theirs = make(rb, 3), make(jrb, 3)
    rng = np.random.default_rng(0)
    for step in range(6):
        batch = _transitions(rng, 24)
        ours.add(batch)
        theirs.add(batch)
        if prioritized:
            got, want = ours.sample(16, beta=0.4), theirs.sample(16, beta=0.4)
        else:
            got, want = ours.sample(16), theirs.sample(16)
        _assert_same(got, want)
        if prioritized:
            pri = np.abs(rng.standard_normal(16))
            epochs = want["item_epochs"].copy()
            epochs[:2] -= 1  # two stale tickets
            assert ours.update_priorities(got["batch_indexes"], pri,
                                          epochs) == \
                theirs.update_priorities(want["batch_indexes"], pri, epochs)
            assert ours.unmatched_priority_updates == \
                theirs.unmatched_priority_updates > 0
    assert len(ours) == len(theirs) == 64
    assert ours.num_added == theirs.num_added == 144
    if prioritized:
        np.testing.assert_array_equal(ours._tree.tree, theirs._tree.tree)
        assert ours._max_priority == theirs._max_priority
    # states cross both ways
    crossed, back = make(jrb, 9), make(rb, 9)
    crossed.set_state(ours.get_state())
    back.set_state(theirs.get_state())
    for a, b in ((crossed, theirs), (back, ours)):
        np.testing.assert_array_equal(a._cols["obs"][:64], b._cols["obs"][:64])
        assert a.num_added == b.num_added and len(a) == len(b)
        if prioritized:
            np.testing.assert_array_equal(a._tree.get(np.arange(64)),
                                          b._tree.get(np.arange(64)))


def _fragment(rng, t_len, n_envs, p_done):
    terms = rng.random((t_len, n_envs)) < p_done
    truncs = (rng.random((t_len, n_envs)) < p_done) & ~terms
    done = np.argwhere(terms | truncs)
    return {
        "obs": rng.standard_normal((t_len, n_envs, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACTIONS, (t_len, n_envs)).astype(np.int32),
        "rewards": rng.standard_normal((t_len, n_envs)).astype(np.float32),
        "raw_rewards": rng.standard_normal((t_len, n_envs)).astype(
            np.float32),
        "terminateds": terms, "truncateds": truncs,
        "last_obs": rng.standard_normal((n_envs, OBS)).astype(np.float32),
        "final_obs_idx": done.astype(np.int64),
        "final_obs_vals": rng.standard_normal((len(done), OBS)).astype(
            np.float32),
    }


@pytest.mark.parametrize("n_step,p_done", [(1, 0.0), (3, 0.0), (1, 0.15),
                                           (3, 0.15), (5, 0.3)])
def test_fragment_to_transitions_equals_jax(n_step, p_done):
    """1-step and n-step windows, with truncations (bootstrapped from the
    final obs) and terminations (done) among the steps."""
    rng = np.random.default_rng(n_step * 10 + int(p_done * 100))
    frag = _fragment(rng, 12, 5, p_done)
    _assert_same(fragment_to_transitions(frag, 0.97, n_step),
                 j_fragment_to_transitions(frag, 0.97, n_step))


# ---- the Q-module and the learner against the JAX package -------------

def _jax_params(jmod, seed=3):
    return jax.device_get(jax.jit(jmod.init_params)(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dueling", [True, False])
def test_dueling_q_forward_matches_jax(dueling):
    jmod = JDuelingQ(OBS, ACTIONS, HIDDENS, dueling=dueling)
    mod = DuelingQMLPModule(OBS, ACTIONS, HIDDENS, dueling=dueling)
    params = _jax_params(jmod)
    mod.load_state_dict(params_from_jax(mod, params))
    obs = np.random.default_rng(1).standard_normal((64, OBS)).astype(
        np.float32)
    want = jmod.forward_train(params, {"obs": jnp.asarray(obs)})
    got = mod.forward_train({"obs": torch.from_numpy(obs)})
    for k in ("action_dist_inputs", "vf_preds"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_epsilon_greedy_exploration():
    """epsilon 0: the greedy action; epsilon 1: uniform over the actions,
    from the runner's generator."""
    mod = DuelingQMLPModule(OBS, ACTIONS, HIDDENS)
    obs = torch.randn(4000, OBS)
    greedy = torch.argmax(mod.forward_train({"obs": obs})
                          ["action_dist_inputs"], -1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a0 = mod.forward_exploration({"obs": obs, "epsilon": torch.tensor(
            0.0)}, gen)["actions"]
        a1 = mod.forward_exploration({"obs": obs, "epsilon": torch.tensor(
            1.0)}, gen)["actions"]
    assert torch.equal(a0, greedy)
    counts = np.bincount(a1.numpy(), minlength=ACTIONS) / len(a1)
    np.testing.assert_allclose(counts, 1 / ACTIONS, atol=0.03)


def _dqn_learners(**training):
    jcfg = JDQNConfig().training(**training)
    cfg = DQNConfig().training(**training).learners(device="cpu")
    dueling = training.get("dueling", True)
    jl = JDQNLearner(JDuelingQ(OBS, ACTIONS, HIDDENS, dueling=dueling), jcfg)
    jl.build(seed=3)
    tl = DQNLearner(DuelingQMLPModule(OBS, ACTIONS, HIDDENS,
                                      dueling=dueling), cfg)
    tl.build(seed=0)
    tl.module.load_state_dict(params_from_jax(
        tl.module, jax.device_get(jl._params)))
    tl._target.load_state_dict(params_from_jax(
        tl._target, jax.device_get(jl._target_params)))
    return jl, tl


def _dqn_batch(n, seed, weights):
    rng = np.random.default_rng(seed)
    b = {"obs": rng.standard_normal((n, OBS)).astype(np.float32),
         "actions": rng.integers(0, ACTIONS, n).astype(np.int32),
         "rewards": rng.standard_normal(n).astype(np.float32),
         "dones": (rng.random(n) < 0.2).astype(np.float32),
         "discounts": np.full(n, 0.99 ** 3, np.float32),
         "next_obs": rng.standard_normal((n, OBS)).astype(np.float32),
         "batch_indexes": rng.permutation(1000)[:n].astype(np.int64),
         "item_epochs": rng.integers(0, 4, n).astype(np.int64)}
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return b


def _assert_grads(tl, jgrads, grads):
    want = params_from_jax(tl.module, jax.device_get(jgrads))
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for (name, _), g in zip(tl.module.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("weights", [True, False])
def test_dqn_loss_grads_and_td_error_match_jax(double_q, weights):
    jl, tl = _dqn_learners(double_q=double_q)
    batch = _dqn_batch(48, seed=5, weights=weights)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jstats), jgrads = jax.value_and_grad(
        lambda p: jl.compute_loss(p, jb, jl.extra_inputs()),
        has_aux=True)(jl._params)
    loss, stats = tl.compute_loss(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        tl.extra_inputs())
    grads = torch.autograd.grad(loss, list(tl.module.parameters()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        got = stats[k].detach().numpy()
        if k in ("td_indexes", "td_epochs"):
            np.testing.assert_array_equal(got, np.asarray(v))
        else:
            np.testing.assert_allclose(got, np.asarray(v), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    _assert_grads(tl, jgrads, grads)


def test_dqn_updates_with_target_sync_match_jax():
    """Three Learner.updates (each a shuffled full batch, as DQN's loop
    runs them) with a hard target sync between them; the returned stats
    follow the JAX package's contract (scalars, and the last minibatch's
    td_error and indexes in their dtypes)."""
    lr = 1e-3
    jl, tl = _dqn_learners(lr=lr)
    for i in range(3):
        batch = _dqn_batch(32, seed=10 + i, weights=True)
        want = jl.update(batch, minibatch_size=None, num_iters=1, seed=i)
        got = tl.update(batch, minibatch_size=None, num_iters=1, seed=i)
        assert set(got) == set(want)
        assert got["td_indexes"].dtype == np.int64
        np.testing.assert_array_equal(got["td_indexes"], want["td_indexes"])
        np.testing.assert_allclose(got["td_error"], want["td_error"],
                                   rtol=1e-4, atol=1e-5)
        for k in ("qf_loss", "mean_q", "total_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
        assert jl.additional_update(update_target=True) == \
            tl.additional_update(update_target=True)
    want = params_from_jax(tl.module, jax.device_get(jl._params))
    target = params_from_jax(tl._target, jax.device_get(jl._target_params))
    for name, p in tl.module.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * lr, err_msg=name)
        np.testing.assert_array_equal(tl._target.state_dict()[name].numpy(),
                                      p.numpy())
        np.testing.assert_allclose(target[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=0)


# ---- configs and algorithms -------------------------------------------

@pytest.mark.parametrize("ours,theirs", [
    (DQNConfig, JDQNConfig), (SimpleQConfig, JSimpleQConfig),
    (SACConfig, JSACConfig), (TD3Config, JTD3Config),
    (DDPGConfig, JDDPGConfig)], ids=lambda c: c.__name__)
def test_config_defaults_equal_jax(ours, theirs):
    got, want = vars(ours()), vars(theirs())
    # the port's config adds only the learners' device
    assert set(got) - set(want) == {"learner_device"}
    assert set(want) - set(got) == set()
    for k, v in want.items():
        if k != "algo_class":
            assert got[k] == v, k
    assert got["algo_class"].__name__ == want["algo_class"].__name__


def test_simple_q_keeps_its_frozen_knobs():
    cfg = SimpleQConfig().training(n_step=1, lr=1e-3)
    assert cfg.lr == 1e-3
    with pytest.raises(ValueError, match="SimpleQ fixes dueling"):
        cfg.training(dueling=True, lr=5.0)
    assert cfg.lr == 1e-3


DQN_STEP = dict(buffer_size=2000, train_batch_size=32,
                num_steps_sampled_before_learning_starts=16,
                target_network_update_freq=100)


@pytest.mark.parametrize("config_cls,extra", [
    (DQNConfig, {}), (DQNConfig, {"prioritized_replay": True}),
    (SimpleQConfig, {})], ids=["dqn", "dqn-prioritized", "simple_q"])
def test_dqn_family_builds_and_trains(config_cls, extra):
    """tests/test_rllib_offpolicy.py's compile-and-step settings: 3
    iterations on CartPole, the learner on the CPU; with prioritized
    replay, priorities move off their max-priority start."""
    algo = (config_cls().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=2)
            .training(**DQN_STEP, **extra).learners(device="cpu")
            .debugging(seed=0).build())
    try:
        for _ in range(3):
            result = algo.train()
        assert result["replay_buffer_size"] > 0
        assert np.isfinite(result["learner"]["qf_loss"])
        assert 0.0 < result["learner"]["epsilon"] <= 1.0
        if extra:
            tree = algo.replay_buffer._tree.get(
                np.arange(len(algo.replay_buffer)))
            assert np.unique(np.round(tree, 6)).size > 1
    finally:
        algo.stop()


def test_dqn_save_restore_keeps_weights_target_and_counter(tmp_path):
    cfg = (DQNConfig().environment("CartPole-v1")
           .training(buffer_size=500,
                     num_steps_sampled_before_learning_starts=32,
                     train_batch_size=16, target_network_update_freq=50)
           .learners(device="cpu"))
    algo = cfg.copy().debugging(seed=0).build()
    algo2 = cfg.copy().debugging(seed=1).build()
    try:
        for _ in range(30):
            algo.train()
        algo.save(str(tmp_path / "ckpt"))
        algo2.restore(str(tmp_path / "ckpt"))
        s, s2 = algo.learner_group.get_state(), \
            algo2.learner_group.get_state()
        for part in ("params", "target_params"):
            for k, v in s[part].items():
                np.testing.assert_array_equal(s2[part][k], v)
        assert algo2._last_target_update == algo._last_target_update > 0
        # the target lags the params between syncs
        assert any(not np.array_equal(s["params"][k],
                                      s["target_params"][k])
                   for k in s["params"])
    finally:
        algo.stop()
        algo2.stop()


def test_dqn_refuses_image_observations():
    with pytest.raises(NotImplementedError, match="1-D observations"):
        DQNConfig().environment("MiniPong-v0").learners(device="cpu").build()


@pytest.mark.parametrize("config_cls,env", [
    (DQNConfig, "CartPole-v1"), (SimpleQConfig, "CartPole-v1"),
    (SACConfig, "Pendulum-v1"), (TD3Config, "Pendulum-v1"),
    (DDPGConfig, "Pendulum-v1")], ids=lambda x: getattr(x, "__name__", x))
def test_learner_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                        config_cls, env):
    """With no learner device the algorithm asks for the card, and raises
    without one before it starts any runner."""
    from ray_tpu_torch.rllib.algorithms.algorithm import EnvRunnerSet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(EnvRunnerSet, "__init__",
                        lambda *a: started.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        config_cls().environment(env).build()
    assert not started
