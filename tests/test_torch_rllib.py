"""The port's PPO through its runtime, on the CPU: a learner gang, CPU
EnvRunner actors, algo.train() and save/restore, against the JAX package.

One cluster for the module (ray_tpu_torch.init(num_cpus=4)); learners on
device="cpu". A 2-learner gloo gang takes 5 full-batch Adam steps and is
held to the local learner as the JAX package's own gang test holds its
gang (tests/test_rl_round3.py:90-112: total_loss within 1e-3, weights
within 1e-3 max abs), and closer: grad_norm (read after the all-reduce)
and total_loss at rtol 1e-5, the weights within 1e-6 (a correct gang
reads 1.2e-7; one with no all-reduce misses the loss bar by 0.93, one
that does not divide by the world doubles grad_norm). Two iterations of
algo.train() through 2 CPU runner actors give the JAX algorithm's result
keys (its local mode, the same settings); the runners never initialise
CUDA, run torch on one thread and hold the learner's weights after the
sync. save/restore mirrors tests/test_rllib.py:160.

IMPALA and APPO: the async pipeline through 2 CPU runner actors
(mirroring tests/test_rl_round3.py:148-176), a 2-rank gloo IMPALA gang
against the local learner on one time-major batch (sharded along the
env axis, 1: a gang that shards the time axis cuts the V-trace
recursion and misses the loss bar), APPO in sync mode (mirroring
tests/test_tracing_appo.py:57-79) and the fault-tolerant actor manager
(mirroring tests/test_fault_tolerance.py:100-130). Each has a deadline
of its own, at most 60 s.
"""

import functools
import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.rllib import PPOConfig as JPPOConfig
from ray_tpu_torch.rllib import (APPOConfig, DiscreteMLPModule,
                                 ImpalaConfig, LearnerGroup, PPOConfig)
from ray_tpu_torch.rllib.algorithms.impala.impala import ImpalaLearner
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOLearner
from ray_tpu_torch.util.actor_manager import FaultTolerantActorManager

SETTINGS = dict(train_batch_size=256, minibatch_size=64, num_epochs=2)
# The gang takes GANG_STEPS full-batch Adam steps at GANG_LR, each moving
# a weight by about GANG_LR: a gang whose ranks step on their own shard's
# grads moves the weights away from the local learner's by about that,
# while a correct all-reduce leaves them within rounding.
GANG_STEPS, GANG_LR, GANG_WEIGHT_ATOL = 5, 1e-2, 1e-6


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _config(num_env_runners=0):
    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=num_env_runners,
                         num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(**SETTINGS).learners(device="cpu"))


def test_gloo_gang_matches_local_learner(cluster):
    cfg = (PPOConfig().environment("CartPole-v1")
           .training(train_batch_size=128, lr=GANG_LR)
           .learners(device="cpu"))
    module = DiscreteMLPModule(4, 2)

    def factory():
        return PPOLearner(module, cfg)

    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.standard_normal((128, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, 128),
        "advantages": rng.standard_normal(128).astype(np.float32),
        "value_targets": rng.standard_normal(128).astype(np.float32),
        "action_logp": np.full(128, -0.69, np.float32),
        "vf_preds": np.zeros(128, np.float32),
    }
    local = LearnerGroup(factory, num_learners=0, seed=5)
    s_local = local.update(dict(batch), minibatch_size=None,
                           num_iters=GANG_STEPS, seed=0)
    w_local = local.get_weights()
    gang = LearnerGroup(factory, num_learners=2, seed=5)
    try:
        reports = ray_tpu_torch.get(
            [a.device_report.remote() for a in gang._actors])
        assert [r["backend"] for r in reports] == ["gloo", "gloo"]
        s_gang = gang.update(dict(batch), minibatch_size=None,
                             num_iters=GANG_STEPS, seed=0)
        w_gang = gang.get_weights()
    finally:
        gang.shutdown()
    assert set(w_gang) == set(w_local)
    # the reference's bar (tests/test_rl_round3.py:108-112)
    assert abs(s_local["total_loss"] - s_gang["total_loss"]) < 1e-3
    diff = max(float(np.max(np.abs(w_local[k] - w_gang[k])))
               for k in w_local)
    assert diff < 1e-3, f"gang diverged from the local learner: {diff}"
    # and closer, at bars set from a correct gang's readings (weights
    # 1.2e-7 apart); grad_norm is read after the all-reduce
    np.testing.assert_allclose(s_gang["grad_norm"], s_local["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(s_gang["total_loss"], s_local["total_loss"],
                               rtol=1e-5)
    assert diff < GANG_WEIGHT_ATOL, \
        f"gang diverged from the local learner: {diff}"


def test_train_through_cpu_runner_actors(cluster):
    algo = _config(num_env_runners=2).build()
    try:
        results = [algo.train() for _ in range(2)]
        states = ray_tpu_torch.get(
            [a.torch_state.remote() for a in algo.env_runners.actors])
        weights = ray_tpu_torch.get(
            [a.get_weights.remote() for a in algo.env_runners.actors])
        learner = algo.learner_group.get_weights()
    finally:
        algo.stop()
    assert states == [{"cuda_initialized": False, "num_threads": 1}] * 2
    for w in weights:
        for k, v in learner.items():
            np.testing.assert_array_equal(w[k], v)
    # 2 runners x 2 envs x (256 // 2 // 2) steps
    assert [r["num_env_steps_trained"] for r in results] == [256, 256]
    assert results[-1]["num_env_steps_sampled_lifetime"] == 512
    assert all(np.isfinite(v) for v in results[-1]["learner"].values())

    jalgo = (JPPOConfig().environment("CartPole-v1")
             .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                          rollout_fragment_length=32)
             .training(**SETTINGS)).build()
    try:
        want = [jalgo.train() for _ in range(2)][-1]
    finally:
        jalgo.stop()
    assert set(results[-1]) == set(want)
    for k in ("env_runners", "learner"):
        assert set(results[-1][k]) == set(want[k]), k


def test_save_restore_roundtrip(tmp_path):
    config = _config()
    algo = config.build()
    algo.train()
    path = algo.save(str(tmp_path / "ckpt"))
    before = algo.learner_group.get_state()
    algo.stop()

    algo2 = config.copy().build()
    algo2.restore(path)
    after = algo2.learner_group.get_state()
    assert set(before["params"]) == set(after["params"])
    for k in before["params"]:
        np.testing.assert_array_equal(before["params"][k],
                                      after["params"][k])
    # Adam's moments and step count came back too (2 epochs x 4 steps)
    opt_b, opt_a = before["opt_state"]["state"], after["opt_state"]["state"]
    assert set(opt_b) == set(opt_a)
    for i in opt_b:
        assert opt_a[i]["step"] == 8
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(opt_b[i][k], opt_a[i][k])
    assert after["kl_coeff"] == before["kl_coeff"]
    assert algo2._iteration == 1
    algo2.stop()


# The JAX IMPALA's async result: Algorithm.train's keys
# (ray_tpu/rllib/algorithms/algorithm.py:191-209) and training_step's
# (ray_tpu/rllib/algorithms/impala/impala.py:339-351, device_feed with a
# local learner); its learner's stats and its feed's stats() keys are held
# in tests/test_torch_impala.py.
JAX_IMPALA_ASYNC_KEYS = {
    "training_iteration", "num_env_steps_sampled_lifetime",
    "time_this_iter_s", "env_runners", "episode_reward_mean", "learner",
    "num_env_steps_trained", "num_env_steps_trained_total",
    "num_updates_total", "num_env_steps_enqueued", "learner_queue_depth",
    "num_healthy_env_runners", "device_feed"}


def test_impala_async_pipeline_trains_through_runner_actors(cluster):
    config = (ImpalaConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=16)
              .training(train_batch_size=128, lr=5e-4,
                        replay_proportion=0.5, replay_buffer_num_slots=8)
              .learners(device="cpu").debugging(seed=0))
    algo = config.build()
    try:
        deadline = time.time() + 60
        trained = 0
        while time.time() < deadline and trained == 0:
            result = algo.train()
            trained = result["num_env_steps_trained"]
            assert result["learner_queue_depth"] <= \
                config.learner_queue_size
        states = ray_tpu_torch.get(
            [a.torch_state.remote() for a in algo.env_runners.actors],
            timeout=60)
    finally:
        algo.stop()
    assert trained > 0, "the background learner never trained a batch"
    assert result["num_healthy_env_runners"] == 2
    assert set(result) == JAX_IMPALA_ASYNC_KEYS
    assert set(result["learner"]) == {"policy_loss", "vf_loss", "entropy",
                                      "total_loss", "grad_norm"}
    feed = result["device_feed"]
    assert feed["batches_fed"] >= result["num_updates_total"] > 0
    assert states == [{"cuda_initialized": False, "num_threads": 1}] * 2


def test_impala_gloo_gang_matches_local_learner(cluster):
    """Three updates of one time-major [8, 8] batch: the gang (each rank
    one half of the 8 envs) against the local learner. The local
    learner's stats lag one update and the gang's do not, as in the JAX
    package. T equals B, so that a gang sharding the time axis fails on
    every rank (its bootstrap values do not fit its values) rather than
    leaving one rank waiting in the all-reduce."""
    cfg = (ImpalaConfig().environment("CartPole-v1")
           .training(lr=GANG_LR, grad_clip=None).learners(device="cpu"))
    factory = functools.partial(ImpalaLearner, DiscreteMLPModule(4, 2), cfg)
    rng = np.random.default_rng(0)
    t, b = 8, 8
    batch = {
        "obs": rng.standard_normal((t, b, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (t, b)).astype(np.int32),
        "rewards": rng.standard_normal((t, b)).astype(np.float32),
        "dones": rng.random((t, b)) < 0.1,
        "behaviour_logp": (-0.69 + 0.3 * rng.standard_normal((t, b))
                           ).astype(np.float32),
        "bootstrap_value": rng.standard_normal(b).astype(np.float32),
    }
    deadline = time.time() + 60
    local = LearnerGroup(factory, num_learners=0, seed=5)
    s_local = [local.update(dict(batch)) for _ in range(3)]
    w_local = local.get_weights()
    gang = LearnerGroup(factory, num_learners=2, seed=5)
    try:
        s_gang = [gang.update(dict(batch)) for _ in range(3)]
        w_gang = gang.get_weights()
    finally:
        gang.shutdown()
    assert time.time() < deadline
    # local: update 1's stats twice, then update 2's; gang: 1, 2, 3
    for got, want in ((s_gang[0], s_local[0]), (s_gang[0], s_local[1]),
                      (s_gang[1], s_local[2])):
        for k in ("total_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    assert set(w_gang) == set(w_local)
    diff = max(float(np.max(np.abs(w_local[k] - w_gang[k])))
               for k in w_local)
    assert diff < GANG_WEIGHT_ATOL, \
        f"gang diverged from the local learner: {diff}"


def test_appo_trains_sync_mode():
    """APPO's clipped V-trace loss runs on CartPole in the degenerate
    sync mode (num_env_runners=0)."""
    config = (APPOConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                           rollout_fragment_length=32)
              .training(train_batch_size=128, lr=1e-3)
              .learners(device="cpu").debugging(seed=0))
    algo = config.build()
    try:
        deadline = time.time() + 60
        stats = {}
        for _ in range(6):
            result = algo.train()
            if result.get("learner"):
                stats = result["learner"]
        assert time.time() < deadline
    finally:
        algo.stop()
    assert "policy_loss" in stats and np.isfinite(stats["policy_loss"]), stats
    assert 0.2 < stats["mean_ratio"] < 5.0


def test_actor_manager_degrades_on_terminal_failure(cluster):
    @ray_tpu_torch.remote  # max_restarts=0: death is terminal
    class Worker:
        def ping(self):
            return "pong"

        def work(self, x):
            return x * 2

        def pid(self):
            return os.getpid()

    actors = [Worker.options(num_cpus=0.1).remote() for _ in range(3)]
    mgr = FaultTolerantActorManager(actors)
    results = mgr.foreach_actor("ping")
    assert [r.ok for r in results] == [True] * 3

    # SIGKILL one actor's process: the pool degrades, doesn't raise.
    os.kill(ray_tpu_torch.get(actors[0].pid.remote()), signal.SIGKILL)
    deadline = time.time() + 30
    while mgr.num_healthy_actors() > 2 and time.time() < deadline:
        mgr.foreach_actor("ping", timeout_seconds=5)
        time.sleep(0.2)
    assert mgr.num_healthy_actors() == 2
    # the healthy remainder still serves work, with no exception raised
    results = mgr.foreach_actor(("work", (21,), None), timeout_seconds=30)
    assert len(results) == 2 and all(r.ok and r.value == 42 for r in results)
    # terminal death: probing does not resurrect
    assert mgr.probe_unhealthy_actors(timeout_seconds=3) == []
    mgr.clear()
