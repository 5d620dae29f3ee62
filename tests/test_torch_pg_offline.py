"""The port's PG, A2C, offline I/O, MARWIL, BC and CQL against the JAX
package's, on the CPU.

JsonWriter/JsonReader are copies of the JAX package's: shards written by
either are byte-identical, and a reader from one seed yields the same
fragments in the same order in both. The JAX learners' params go
through params_from_jax into the port's, and the same batches (numpy,
from np.random.default_rng) through both, f32 on device="cpu". Bars
(PPO's, tests/test_torch_rllib_learner.py): loss and stats at rtol 1e-5,
each grad at rtol 1e-5 with an atol of 1e-5 times the largest grad
element; after three Adam updates, params (and CQL's polyak targets) at
rtol 1e-4 with an atol of 1e-4 times the learning rate. CQL's loss takes
the JAX loss's own draws: SAC's two from the loss key, and the
penalty's uniform candidates and policy-sample normal from
fold_in(key, 991), split as cql.py splits them. Every config default
equals the JAX package's; each algorithm builds and trains at the JAX
compile tests' settings, and save/restore keeps MARWIL's advantage
normalizer and CQL's targets.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.rllib.algorithms.a2c.a2c import A2CConfig as JA2CConfig
from ray_tpu.rllib.algorithms.a2c.a2c import A2CLearner as JA2CLearner
from ray_tpu.rllib.algorithms.cql.cql import CQLConfig as JCQLConfig
from ray_tpu.rllib.algorithms.cql.cql import CQLLearner as JCQLLearner
from ray_tpu.rllib.algorithms.marwil.marwil import BCConfig as JBCConfig
from ray_tpu.rllib.algorithms.marwil.marwil import \
    MARWILConfig as JMARWILConfig
from ray_tpu.rllib.algorithms.marwil.marwil import \
    MARWILLearner as JMARWILLearner
from ray_tpu.rllib.algorithms.pg.pg import PGConfig as JPGConfig
from ray_tpu.rllib.algorithms.pg.pg import PGLearner as JPGLearner
from ray_tpu.rllib.algorithms.sac.sac import \
    SquashedGaussianModule as JSquashed
from ray_tpu.rllib.core.catalog import DiscreteMLPModule as JMLP
from ray_tpu.rllib.offline.json_io import JsonReader as JJsonReader
from ray_tpu.rllib.offline.json_io import JsonWriter as JJsonWriter
from ray_tpu_torch.rllib import (A2CConfig, BCConfig, CQLConfig,
                                 DiscreteMLPModule, ESConfig, MARWILConfig,
                                 PGConfig,
                                 PPOConfig, params_from_jax)
from ray_tpu_torch.rllib.algorithms.a2c.a2c import A2CLearner
from ray_tpu_torch.rllib.algorithms.cql.cql import CQLLearner
from ray_tpu_torch.rllib.algorithms.marwil.marwil import MARWILLearner
from ray_tpu_torch.rllib.algorithms.pg.pg import PGLearner
from ray_tpu_torch.rllib.algorithms.sac.sac import SquashedGaussianModule
from ray_tpu_torch.rllib.core.learner import index_matrix
from ray_tpu_torch.rllib.offline.json_io import JsonReader, JsonWriter


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent.parent / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep = _load("rllib_learning_sweep")

OBS, ACT, LOW, HIGH = 3, 2, [-2.0, -1.0], [2.0, 3.0]


def _fragment(rng, t=6, n=3):
    return {"obs": rng.standard_normal((t, n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (t, n)).astype(np.int32),
            "rewards": np.ones((t, n), np.float32),
            "terminateds": rng.random((t, n)) < 0.1,
            "truncateds": np.zeros((t, n), bool),
            "vf_preds": rng.standard_normal((t, n)).astype(np.float32),
            "bootstrap_value": rng.standard_normal(n).astype(np.float32),
            "last_obs": rng.standard_normal((n, 4)).astype(np.float32),
            "worker_index": 2, "module_order": ["a", "b"],
            "episode_metrics": [{"episode_return": 1.0}]}


def test_json_io_writes_the_same_shards_and_reads_in_the_same_order(
        tmp_path):
    """Both writers roll over at the same size into byte-identical
    shards (episode_metrics left out); two readers from one seed yield
    the same fragments, dtypes and shapes kept, cycling past the end."""
    rng = np.random.default_rng(0)
    frags = [_fragment(rng) for _ in range(12)]
    for cls, d in ((JsonWriter, "port"), (JJsonWriter, "jax")):
        w = cls(str(tmp_path / d), max_file_size=2000)
        for f in frags:
            w.write(f)
        w.close()
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) > 2
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert "episode_metrics" not in json.loads(
        (tmp_path / "port" / names[0]).read_text().splitlines()[0])
    for shuffle in (True, False):
        got = JsonReader(str(tmp_path / "port"), shuffle=shuffle, seed=3)
        want = JJsonReader(str(tmp_path / "port"), shuffle=shuffle, seed=3)
        assert len(got) == len(want) == 12
        for _ in range(30):
            a, b = got.next(), want.next()
            assert set(a) == set(b)
            for k, v in b.items():
                if isinstance(v, np.ndarray):
                    assert a[k].dtype == v.dtype and a[k].shape == v.shape
                    np.testing.assert_array_equal(a[k], v)
                else:
                    assert a[k] == v
    with pytest.raises(FileNotFoundError):
        JsonReader(str(tmp_path / "none"))


def test_a_tensor_column_is_a_fault(tmp_path):
    w = JsonWriter(str(tmp_path))
    with pytest.raises(TypeError):
        w.write({"obs": torch.zeros(2)})
    w.close()


@pytest.mark.parametrize("name", ["PG", "A2C", "MARWIL", "BC", "CQL"])
def test_config_defaults_match_jax(name):
    jax_cfg, cfg = {
        "PG": (JPGConfig, PGConfig), "A2C": (JA2CConfig, A2CConfig),
        "MARWIL": (JMARWILConfig, MARWILConfig),
        "BC": (JBCConfig, BCConfig), "CQL": (JCQLConfig, CQLConfig)}[name]
    want, got = vars(jax_cfg()), vars(cfg())
    assert set(got) - set(want) == {"learner_device"}
    for k, v in want.items():
        if k != "algo_class":
            assert got[k] == v, k
    assert got["algo_class"].__name__ == want["algo_class"].__name__


def test_full_batch_sweep_draws_as_jax():
    """minibatch_size=None: one shuffled full batch an epoch, from the
    seed the JAX sweep draws it from."""
    rng = np.random.default_rng(11)
    np.testing.assert_array_equal(index_matrix(37, 37, 1, 11),
                                  rng.permutation(37)[None])
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(
        index_matrix(20, 20, 2, 5),
        np.stack([rng.permutation(20), rng.permutation(20)]))


def _pg_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32),
            "action_logp": np.full(n, -0.69, np.float32),
            "vf_preds": rng.standard_normal(n).astype(np.float32)}


def _cql_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "actions": rng.uniform(LOW, HIGH, (n, ACT)).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": (rng.random(n) < 0.2).astype(np.float32),
            "discounts": np.full(n, 0.99, np.float32),
            "next_obs": rng.standard_normal((n, OBS)).astype(np.float32)}


def _learners(kind, **training):
    """(JAX learner, the port's learner holding its params)."""
    if kind == "cql":
        jl = JCQLLearner(JSquashed(OBS, ACT, LOW, HIGH, (32, 32)),
                         JCQLConfig().training(**training))
        tl = CQLLearner(SquashedGaussianModule(OBS, ACT, LOW, HIGH,
                                               (32, 32)),
                        CQLConfig().training(**training).learners(
                            device="cpu"))
    else:
        jcls, cls, jcfg, cfg = {
            "pg": (JPGLearner, PGLearner, JPGConfig, PGConfig),
            "a2c": (JA2CLearner, A2CLearner, JA2CConfig, A2CConfig),
            "marwil": (JMARWILLearner, MARWILLearner, JMARWILConfig,
                       MARWILConfig),
            "bc": (JMARWILLearner, MARWILLearner, JBCConfig, BCConfig),
        }[kind]
        jl = jcls(JMLP(4, 2, (32, 32)), jcfg().training(**training))
        tl = cls(DiscreteMLPModule(4, 2, (32, 32)),
                 cfg().training(**training).learners(device="cpu"))
    jl.build(seed=3)
    tl.build(seed=0)
    tl.module.load_state_dict(params_from_jax(
        tl.module, jax.device_get(jl._params)))
    if kind == "cql":
        tl._target.load_state_dict(params_from_jax(
            tl._target, jax.device_get(jl._target)))
    return jl, tl


def _cql_draws(key, b, n=4):
    """The JAX CQL loss's draws from its loss key, as numpy: SAC's next
    and current normals (sac.py:175), then the penalty's uniform
    candidates and policy-sample normal (cql.py:52-62)."""
    k_next, k_pi = jax.random.split(key)
    k_unif, k_cand = jax.random.split(jax.random.fold_in(key, 991))
    return (np.array(jax.random.normal(k_next, (b, ACT))),
            np.array(jax.random.normal(k_pi, (b, ACT))),
            np.array(jax.random.uniform(k_unif, (n, b, ACT),
                                        minval=jnp.asarray(LOW),
                                        maxval=jnp.asarray(HIGH))),
            np.array(jax.random.normal(k_cand, (n * b, ACT))))


LOSS_CASES = [("pg", {}), ("a2c", {}), ("marwil", {"beta": 0.0}),
              ("marwil", {"beta": 1.0}), ("bc", {}), ("cql", {})]


@pytest.mark.parametrize("kind,training", LOSS_CASES,
                         ids=[f"{k}-{t}" for k, t in LOSS_CASES])
def test_loss_and_grads_match_jax(kind, training):
    jl, tl = _learners(kind, entropy_coeff=0.01, **training)
    if kind == "cql":
        batch = _cql_batch(24, seed=4)
        key = jax.random.PRNGKey(21)
        jextra = {"target": jl._target, "rng": key}
        noise = tuple(torch.from_numpy(x) for x in _cql_draws(key, 24))
        args = (noise,)
    else:
        batch = _pg_batch(40, seed=4)
        jextra, args = jl.extra_inputs(), ()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jl.compute_loss(p, jb, jextra), has_aux=True))(jl._params)
    loss, stats = tl.compute_loss(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        tl.extra_inputs(), *args)
    grads = torch.autograd.grad(loss, list(tl.module.parameters()),
                                allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want = params_from_jax(tl.module, jax.device_get(jgrads))
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for (name, p), g in zip(tl.module.named_parameters(), grads):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
    if kind == "cql":
        assert "cql_loss" in stats


@pytest.mark.parametrize("kind,training", LOSS_CASES,
                         ids=[f"{k}-{t}" for k, t in LOSS_CASES])
def test_three_adam_updates_match_jax(kind, training):
    """Three Learner.updates (two minibatches an update where the
    algorithm takes minibatches), then CQL's polyak step."""
    lr = 1e-2 if kind != "cql" else 3e-4
    jl, tl = _learners(kind, lr=lr, **training)
    for i in range(3):
        if kind == "cql":
            batch = _cql_batch(32, seed=30 + i)
            draws = _cql_draws(jax.random.split(jl._rng)[1], 32)
            noise = tuple(torch.from_numpy(x) for x in draws)
            tl.draw_noise = lambda b, g, noise=noise: noise
            mb = None
        else:
            batch = _pg_batch(64, seed=30 + i)
            mb = 32 if kind in ("marwil", "bc") else None
        want = jl.update(batch, minibatch_size=mb, num_iters=1, seed=i)
        got = tl.update(batch, minibatch_size=mb, num_iters=1, seed=i)
        for k in ("total_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
        if kind == "cql":
            jl.additional_update(polyak=True)
            tl.additional_update(polyak=True)
    params = params_from_jax(tl.module, jl.get_weights())
    for name, p in tl.module.state_dict().items():
        np.testing.assert_allclose(p.numpy(), params[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * lr, err_msg=name)
    if kind == "cql":
        target = params_from_jax(tl._target, jax.device_get(jl._target))
        for name, p in tl._target.state_dict().items():
            np.testing.assert_allclose(p.numpy(), target[name].numpy(),
                                       rtol=1e-4, atol=1e-4 * lr,
                                       err_msg=name)


@pytest.fixture(scope="module")
def expert_data(tmp_path_factory):
    """2,000 steps of the hand-coded balancer, recorded by the port."""
    path = str(tmp_path_factory.mktemp("expert"))
    assert sweep.record_expert_data("ray_tpu_torch", path, 2000) > 150
    return path


def test_marwil_batch_matches_jax(expert_data, monkeypatch):
    """One MARWIL iteration from the same data, weights and seed: the
    reader picks the same fragments, the values recomputed on the
    learner's device (one forward) equal the JAX package's per-fragment
    ones, and the advantages normalised by the moving average give the
    same update batch."""
    settings = dict(lr=1e-3, beta=1.0, train_batch_size=500,
                    minibatch_size=128, evaluation_interval=0)
    jalgo = (JMARWILConfig().environment("CartPole-v1")
             .offline_data(input_=expert_data).training(**settings)
             .debugging(seed=1).build())
    algo = (MARWILConfig().environment("CartPole-v1")
            .offline_data(input_=expert_data).training(**settings)
            .learners(device="cpu").debugging(seed=1).build())
    try:
        algo.learner_group.set_weights(params_from_jax(
            algo.module, jalgo.learner_group.get_weights()))
        seen = {}
        for name, a in (("jax", jalgo), ("port", algo)):
            def spy(batch, name=name, **kw):
                seen[name] = batch
                return {}
            monkeypatch.setattr(a.learner_group, "update", spy)
            a.train()
        assert set(seen["port"]) == set(seen["jax"])
        for k, v in seen["jax"].items():
            np.testing.assert_allclose(seen["port"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        assert algo._sqd_adv_norm == pytest.approx(jalgo._sqd_adv_norm,
                                                   rel=1e-6)
    finally:
        jalgo.stop()
        algo.stop()


def test_pg_and_a2c_build_and_train():
    """The JAX package's compile-test settings: A2C microbatches of 128
    (tests/test_rl_round4.py), PG's full batch."""
    for cfg in (PGConfig().training(train_batch_size=256),
                A2CConfig().training(train_batch_size=512,
                                     microbatch_size=128)):
        algo = (cfg.environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=4,
                             rollout_fragment_length=32)
                .learners(device="cpu").debugging(seed=0).build())
        try:
            for _ in range(2):
                result = algo.train()
            assert np.isfinite(result["learner"]["total_loss"])
            assert result["num_env_steps_trained"] >= 128
            if isinstance(cfg, A2CConfig):
                assert algo.config.minibatch_size == 128
        finally:
            algo.stop()


def test_bc_marwil_train_and_save_restore(expert_data, tmp_path):
    for cls, beta in ((BCConfig, 0.0), (MARWILConfig, 1.0)):
        cfg = (cls().environment("CartPole-v1")
               .offline_data(input_=expert_data)
               .training(lr=1e-3, train_batch_size=500, minibatch_size=128,
                         evaluation_interval=2, evaluation_duration=100)
               .learners(device="cpu"))
        algo = cfg.copy().debugging(seed=0).build()
        other = cfg.copy().debugging(seed=4).build()
        try:
            for _ in range(2):
                result = algo.train()
            st = result["learner"]
            assert result["num_offline_steps_trained"] >= 500
            assert st["mean_imitation_weight"] > 0
            assert (st["sqd_adv_norm"] != 1.0) == (beta > 0)
            assert (st["vf_loss"] == 0.0) == (beta == 0)
            algo.save(str(tmp_path / cls.__name__))
            other.restore(str(tmp_path / cls.__name__))
            assert other._sqd_adv_norm == algo._sqd_adv_norm
            w, w2 = (algo.learner_group.get_weights(),
                     other.learner_group.get_weights())
            assert all(np.array_equal(w[k], w2[k]) for k in w)
        finally:
            algo.stop()
            other.stop()
    with pytest.raises(ValueError, match="offline"):
        BCConfig().environment("CartPole-v1").learners(device="cpu").build()


def test_output_records_fragments_then_cql_trains_on_them(tmp_path):
    """tests/test_rl_round4.py's CQL test: SAC records Pendulum fragments
    through offline_data(output=), CQL trains on them with a finite
    cql_loss that moves; save/restore keeps its targets."""
    from ray_tpu_torch.rllib import SACConfig, register_env
    register_env("Pendulum-v1", _load("chip_smoke").Pendulum)
    out = str(tmp_path / "data")
    rec = (SACConfig().environment("Pendulum-v1")
           .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=16)
           .training(train_batch_size=64,
                     num_steps_sampled_before_learning_starts=64)
           .rl_module(model_hiddens=(32, 32))
           .offline_data(output=out).learners(device="cpu")
           .debugging(seed=0).build())
    try:
        for _ in range(3):
            rec.train()
    finally:
        rec.stop()
    frag = JsonReader(out, shuffle=False).next()
    assert frag["obs"].shape == (16, 4, 3) and "episode_metrics" not in frag
    cfg = (CQLConfig().environment("Pendulum-v1")
           .training(train_batch_size=64).rl_module(model_hiddens=(32, 32))
           .offline_data(input_=out).learners(device="cpu"))
    algo = cfg.copy().debugging(seed=0).build()
    other = cfg.copy().debugging(seed=2).build()
    try:
        results = [algo.train() for _ in range(3)]
        cql = [r["learner"]["cql_loss"] for r in results]
        assert all(np.isfinite(cql)) and cql[0] != cql[-1]
        assert all(r["num_offline_steps_trained"] == 64 for r in results)
        algo.save(str(tmp_path / "ckpt"))
        other.restore(str(tmp_path / "ckpt"))
        s, s2 = (algo.learner_group.get_state(),
                 other.learner_group.get_state())
        for k, v in s["target"].items():
            np.testing.assert_array_equal(s2["target"][k], v)
    finally:
        algo.stop()
        other.stop()
    with pytest.raises(ValueError, match="offline"):
        CQLConfig().environment("Pendulum-v1").learners(device="cpu").build()


def test_learners_default_to_the_card(monkeypatch):
    from ray_tpu_torch.rllib import make_multi_agent, register_env
    register_env("ma_cartpole_pg_offline", make_multi_agent("CartPole-v1"))
    """device=None asks for CUDA and raises without it, for every new
    algorithm, before any runner starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (PGConfig(), A2CConfig(), ESConfig(),
                BCConfig().offline_data(input_="/nonexistent/x"),
                MARWILConfig().offline_data(input_="/nonexistent/x"),
                PPOConfig().offline_data(output="/nonexistent/x"),
                PPOConfig().environment(
                    "ma_cartpole_pg_offline", {"num_agents": 2})
                .multi_agent(policies={"p": None},
                             policy_mapping_fn=lambda a: "p")):
        with pytest.raises(RuntimeError, match="CUDA"):
            if cfg.env is None:
                cfg.environment("CartPole-v1")
            cfg.build()
    from ray_tpu_torch.rllib import register_env
    register_env("Pendulum-v1", _load("chip_smoke").Pendulum)
    with pytest.raises(RuntimeError, match="CUDA"):
        CQLConfig().environment("Pendulum-v1").offline_data(
            input_="/nonexistent/x").build()
