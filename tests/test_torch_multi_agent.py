"""The port's multi-agent PPO and connector pipelines against the JAX
package's, on the CPU.

MultiAgentRLModule's params convert from the JAX package's multi-agent
tree {module_id: tree}. The multi-agent minibatch index sets equal the
JAX learner's bit for bit (per-module sizes round(minibatch * n_m /
total), one permutation a module and epoch drawn in the batch's dict
order). Two-policy PPO's summed loss, per-module stats and per-module
grads at PPO's bars (rtol 1e-5; each grad's atol 1e-5 times the largest
grad element), and three Adam updates with a grad clip (the global norm
over the union of the modules' params) at rtol 1e-4 with an atol of 1e-4
times the learning rate. Every connector and deepmind_connectors equal
the JAX package's on one obs stream, bit for bit, lane resets and final
observations included. A runner routes each lane to its module; the
algorithm trains both modules, checks the roster, and saves and restores
the connectors' state; a 2-rank gloo gang's two-policy update equals the
local learner's (the bars of tests/test_torch_rllib.py's gang test).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ray_tpu_torch
from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib.algorithms.ppo.ppo import PPOConfig as JPPOConfig
from ray_tpu.rllib.algorithms.ppo.ppo import \
    MultiAgentPPOLearner as JMALearner
from ray_tpu.rllib.core.catalog import DiscreteMLPModule as JMLP
from ray_tpu.rllib.core.marl_module import \
    MultiAgentRLModule as JMultiAgentRLModule
from ray_tpu_torch.rllib import (DiscreteMLPModule, LearnerGroup,
                                 MultiAgentRLModule, PPOConfig,
                                 make_multi_agent, params_from_jax,
                                 register_env)
from ray_tpu_torch.rllib import connectors as conn
from ray_tpu_torch.rllib.algorithms.ppo.ppo import MultiAgentPPOLearner
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

MIDS = ("pol_a", "pol_b")
register_env("ma_cartpole_torch", make_multi_agent("CartPole-v1"))


def policy(agent_id):
    return "pol_a" if agent_id == "agent_0" else "pol_b"


def _module(hiddens=(16, 16)):
    return MultiAgentRLModule({m: DiscreteMLPModule(4, 2, hiddens)
                               for m in MIDS})


def _learners(**training):
    jmod = JMultiAgentRLModule({m: JMLP(4, 2, (16, 16)) for m in MIDS})
    jl = JMALearner(jmod, JPPOConfig().training(**training))
    jl.build(seed=3)
    tl = MultiAgentPPOLearner(_module(), PPOConfig().training(
        **training).learners(device="cpu"))
    tl.build(seed=0)
    tl.module.load_state_dict(params_from_jax(tl.module,
                                              jax.device_get(jl._params)))
    return jl, tl


def _batch(sizes, seed):
    """A nested batch {module_id: columns}, in the dict order `sizes`
    gives (pol_b first: the draws follow the dict's order)."""
    rng = np.random.default_rng(seed)
    return {mid: {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "value_targets": rng.standard_normal(n).astype(np.float32),
        "action_logp": (-0.7 + 0.1 * rng.standard_normal(n)).astype(
            np.float32),
        "vf_preds": rng.standard_normal(n).astype(np.float32)}
        for mid, n in sizes.items()}


def test_module_keys_and_conversion():
    module = MultiAgentRLModule({"pol_b": DiscreteMLPModule(4, 2, (8,)),
                                 "pol_a": DiscreteMLPModule(4, 2, (8,))})
    assert module.module_ids == ["pol_a", "pol_b"]
    assert list(module.state_dict())[0] == "pol_a.torso.0.weight"
    tree = jax.device_get(JMultiAgentRLModule(
        {m: JMLP(4, 2, (8,)) for m in MIDS}).init_params(
            jax.random.PRNGKey(0)))
    state = params_from_jax(module, tree)
    module.load_state_dict(state)
    np.testing.assert_array_equal(
        module["pol_b"].pi[0].weight.detach().numpy(),
        np.asarray(tree["pol_b"]["pi"][0]["w"]).T)
    with pytest.raises(KeyError):
        params_from_jax(module, {"pol_a": tree["pol_a"]})


@pytest.mark.parametrize("sizes,minibatch,iters", [
    ({"pol_b": 300, "pol_a": 200}, 128, 3),
    ({"pol_a": 64, "pol_b": 96}, None, 2),
    ({"pol_b": 40, "pol_a": 7}, 16, 2)])
def test_minibatch_index_sets_equal_jax(sizes, minibatch, iters):
    jl, _ = _learners()
    seen = []
    jl._loop_sweep = lambda dev_batch, steps: seen.extend(steps) or {}
    jl.update(_batch(sizes, 0), minibatch_size=minibatch, num_iters=iters,
              seed=7)
    got = MultiAgentPPOLearner.module_index_sets(sizes, minibatch, iters, 7)
    assert list(got) == list(sizes)
    assert all(len(v) == len(seen) for v in got.values())
    for s, want in enumerate(seen):
        for mid in sizes:
            np.testing.assert_array_equal(got[mid][s], want[mid])


def test_two_policy_loss_and_grads_match_jax():
    jl, tl = _learners(entropy_coeff=0.01, clip_param=0.2)
    batch = _batch({"pol_a": 40, "pol_b": 24}, seed=4)
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jl.compute_loss(p, jb, jl.extra_inputs()),
        has_aux=True))(jl._params)
    loss, stats = tl.compute_loss(
        {m: {k: torch.from_numpy(v) for k, v in b.items()}
         for m, b in batch.items()}, tl.extra_inputs())
    grads = torch.autograd.grad(loss, list(tl.module.parameters()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(stats) == set(jstats)
    assert "pol_a/policy_loss" in stats and "pol_b/vf_loss" in stats
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k].item(), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = params_from_jax(tl.module, jax.device_get(jgrads))
    for mid in MIDS:  # per-module grads, each at its module's scale
        scale = max(float(np.abs(w.numpy()).max())
                    for k, w in want.items() if k.startswith(mid))
        for (name, _), g in zip(tl.module.named_parameters(), grads):
            if name.startswith(mid):
                np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                           rtol=1e-5, atol=1e-5 * scale,
                                           err_msg=name)


def test_three_clipped_updates_match_jax():
    lr = 1e-2
    jl, tl = _learners(lr=lr, grad_clip=0.5, entropy_coeff=0.01)
    for i in range(3):
        batch = _batch({"pol_b": 96, "pol_a": 64}, seed=10 + i)
        want = jl.update(batch, minibatch_size=64, num_iters=2, seed=i)
        got = tl.update(batch, minibatch_size=64, num_iters=2, seed=i)
        assert want["grad_norm"] > 2 * 0.5  # the clip fired
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        kl = tl.additional_update(mean_kl=got["mean_kl_loss"])
        assert kl == jl.additional_update(mean_kl=want["mean_kl_loss"])
    params = params_from_jax(tl.module, jl.get_weights())
    for name, p in tl.module.state_dict().items():
        np.testing.assert_allclose(p.numpy(), params[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * lr, err_msg=name)


def _stream(n_steps=12, lanes=3, shape=(30, 40, 3), seed=0):
    """An obs stream of uint8 frames with lane ends: (first obs, [(obs,
    rewards, terms, truncs, finals)])."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, 256, (lanes, *shape), dtype=np.uint8)
    steps = []
    for _ in range(n_steps):
        terms = rng.random(lanes) < 0.2
        truncs = ~terms & (rng.random(lanes) < 0.1)
        finals = [rng.integers(0, 256, shape, dtype=np.uint8)
                  if terms[i] or truncs[i] else None for i in range(lanes)]
        steps.append((rng.integers(0, 256, (lanes, *shape), dtype=np.uint8),
                       (3 * rng.standard_normal(lanes)).astype(np.float32),
                       terms, truncs, finals))
    return first, steps


def _pipelines(name):
    if name == "deepmind":
        return (conn.ConnectorPipeline(conn.deepmind_connectors(dim=20)),
                jconn.ConnectorPipeline(jconn.deepmind_connectors(dim=20)))
    build = {"gray": lambda m: [m.GrayscaleResizeConnector(dim=24)],
             "stack": lambda m: [m.FrameStackConnector(k=3)],
             "clip_sign": lambda m: [m.ClipRewardConnector(sign=True)],
             "clip_bound": lambda m: [m.ClipRewardConnector(sign=False,
                                                            bound=1.5)],
             "mean_std": lambda m: [m.MeanStdFilterConnector(clip=3.0)]}
    return (conn.ConnectorPipeline(build[name](conn)),
            jconn.ConnectorPipeline(build[name](jconn)))


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["gray", "stack", "clip_sign",
                                  "clip_bound", "mean_std", "deepmind"])
def test_connectors_equal_jax_on_one_stream(name):
    ours, theirs = _pipelines(name)
    first, steps = _stream()
    if name == "mean_std":  # a float stream
        first = first.astype(np.float32)
        steps = [(o.astype(np.float32), r, t, tr,
                  [None if f is None else f.astype(np.float32) for f in fs])
                 for o, r, t, tr, fs in steps]
    from ray_tpu.rllib.env.spaces import Box as JBox

    from ray_tpu_torch.rllib.env.spaces import Box
    space = ours.observation_space(Box(0, 255, first.shape[1:], np.uint8))
    jspace = theirs.observation_space(JBox(0, 255, first.shape[1:],
                                           np.uint8))
    assert (space.shape, space.dtype) == (jspace.shape, jspace.dtype)
    _same(ours.on_reset(first.copy()), theirs.on_reset(first.copy()))
    for obs, rew, terms, truncs, finals in steps:
        got = ours.on_step(obs.copy(), rew.copy(), terms, truncs,
                           list(finals))
        want = theirs.on_step(obs.copy(), rew.copy(), terms, truncs,
                              list(finals))
        _same(got[0], want[0])
        _same(got[1], want[1])
        for f, g in zip(got[2], want[2]):
            _same(f, g)
    for s, t in zip(ours.get_state(), theirs.get_state()):
        assert set(s) == set(t)
        for k in s:
            _same(s[k], t[k]) if isinstance(t[k], np.ndarray) \
                else (s[k] == t[k]) or pytest.fail(k)
    actions = np.array([[2.0], [-3.0], [0.5]])
    _same(conn.ClipActionConnector(-1.0, 1.0)(actions),
          jconn.ClipActionConnector(-1.0, 1.0)(actions))


def test_runner_routes_each_lane_to_its_module():
    """2 envs x 2 agents: lanes 0 and 2 are agent_0's (pol_a), 1 and 3
    agent_1's (pol_b). pol_a's head always picks action 0, pol_b's action
    1; the fragment's logp and values are each lane's module's."""
    module = _module()
    with torch.no_grad():
        for mid, sign in (("pol_a", 1.0), ("pol_b", -1.0)):
            module[mid].pi[0].bias.copy_(torch.tensor([20.0, -20.0]) * sign)
    runner = SingleAgentEnvRunner("ma_cartpole_torch", _module(),
                                  {"num_agents": 2}, num_envs=2, seed=1,
                                  policy_mapping_fn=policy)
    runner.set_weights({k: v.numpy() for k, v in module.state_dict().items()})
    assert runner._lane_module_ids == ["pol_a", "pol_b", "pol_a", "pol_b"]
    frag = runner.sample(80)
    assert frag["module_order"] == ["pol_a", "pol_b"]
    np.testing.assert_array_equal(frag["lane_module"], [0, 1, 0, 1])
    np.testing.assert_array_equal(frag["actions"][:, [0, 2]], 0)
    np.testing.assert_array_equal(frag["actions"][:, [1, 3]], 1)
    for lane, mid in enumerate(runner._lane_module_ids):
        with torch.no_grad():
            out = module[mid].forward_train(
                {"obs": torch.from_numpy(frag["obs"][:, lane])})
        np.testing.assert_allclose(frag["vf_preds"][:, lane],
                                   out["vf_preds"].numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown module"):
        SingleAgentEnvRunner("ma_cartpole_torch", _module(),
                             {"num_agents": 2}, policy_mapping_fn=str)


def _ma_config(**training):
    return (PPOConfig().environment("ma_cartpole_torch",
                                    env_config={"num_agents": 2})
            .env_runners(num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .training(**{**dict(train_batch_size=64, minibatch_size=32,
                                num_epochs=2), **training})
            .multi_agent(policies={"pol_a": None, "pol_b": None},
                         policy_mapping_fn=policy)
            .learners(device="cpu").debugging(seed=3))


def test_two_policy_ppo_trains_both_modules():
    """tests/test_multi_agent.py's runner-routing test on the port: two
    iterations, per-module stats, both modules' params move."""
    algo = _ma_config().build()
    try:
        assert isinstance(algo.module, MultiAgentRLModule)
        w0 = algo.learner_group.get_weights()
        assert {k.split(".", 1)[0] for k in w0} == set(MIDS)
        for _ in range(2):
            result = algo.train()
        assert result["num_env_steps_trained"] == 64
        for mid in MIDS:
            assert np.isfinite(result["learner"][f"{mid}/policy_loss"])
        w1 = algo.learner_group.get_weights()
        for mid in MIDS:
            assert any(np.abs(w1[k] - w0[k]).max() > 0
                       for k in w0 if k.startswith(mid)), mid
        runner_w = algo.env_runners._local.get_weights()
        assert all(np.array_equal(runner_w[k], w1[k]) for k in w1)
    finally:
        algo.stop()
    with pytest.raises(ValueError, match="never produced"):
        _ma_config().multi_agent(
            policies={"pol_a": None, "pol_b": None, "pol_c": None}).build()


def test_connector_state_survives_save_restore(tmp_path):
    def config(seed):
        return (PPOConfig().environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=2,
                             rollout_fragment_length=16,
                             env_connectors=[
                                 conn.MeanStdFilterConnector(),
                                 conn.ClipRewardConnector(sign=False,
                                                          bound=0.5)])
                .training(train_batch_size=64, minibatch_size=32,
                          num_epochs=1)
                .learners(device="cpu").debugging(seed=seed))
    algo, other = config(0).build(), config(5).build()
    try:
        result = algo.train()
        # the clip connector's rewards reach the metrics: 0.5 a step
        assert algo.observation_space.dtype == np.float32
        assert result["num_env_steps_trained"] >= 64
        algo.save(str(tmp_path / "ckpt"))
        other.restore(str(tmp_path / "ckpt"))
        (state,), (restored,) = (algo.env_runners.get_connector_states(),
                                 other.env_runners.get_connector_states())
        assert state[0]["count"] == restored[0]["count"] > 64
        for k in ("mean", "m2"):
            np.testing.assert_array_equal(restored[0][k], state[0][k])
        frag = algo.env_runners._local.sample(8)
        assert np.all(np.abs(frag["obs"]) <= 10.0)
        assert set(np.unique(frag["rewards"])) <= {0.5}
    finally:
        algo.stop()
        other.stop()


def test_two_rank_gloo_update_equals_one_rank():
    """The nested batch sharded per module over 2 gloo ranks: three
    full-batch steps equal the local learner's (total_loss and grad_norm
    rtol 1e-5, weights within 1e-6)."""
    cfg = PPOConfig().training(lr=1e-2).learners(device="cpu")
    module = _module()

    def factory():
        return MultiAgentPPOLearner(module, cfg)

    batch = _batch({"pol_a": 64, "pol_b": 32}, seed=0)
    local = LearnerGroup(factory, num_learners=0, seed=5)
    s_local = local.update(batch, minibatch_size=None, num_iters=3, seed=0)
    w_local = local.get_weights()
    ray_tpu_torch.init(num_cpus=3)
    try:
        gang = LearnerGroup(factory, num_learners=2, seed=5)
        try:
            s_gang = gang.update(batch, minibatch_size=None, num_iters=3,
                                 seed=0)
            w_gang = gang.get_weights()
        finally:
            gang.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    for k in ("total_loss", "grad_norm", "pol_a/policy_loss"):
        np.testing.assert_allclose(s_gang[k], s_local[k], rtol=1e-5,
                                   err_msg=k)
    diff = max(float(np.abs(w_local[k] - w_gang[k]).max()) for k in w_local)
    assert diff < 1e-6, diff
