"""The port's replay plane (rllib/utils/replay/), DQN through it, a DQN
learner gang, and the ownership ring's repair, on the CPU.

Bit for bit against the JAX package: route_shard, and a shard's pushes,
samples and priority updates with stale epoch tickets dropped and
counted. On the port's runtime (one ray_tpu_torch.init(num_cpus=4) for
the module): DQN through two prioritized shards at
tests/test_replay_plane.py's settings, its learner fed by the DeviceFeed
and util.state.replay_shards() listing the shards; a 2-rank gloo DQN
learner gang whose update equals a local learner's on the same batch
(params at rtol 1e-5 with an atol of 1e-5 times the learning rate: the
gang's grad is the mean of two half-batch grads). The transition ring
survives a record() re-entered from a finalizer on its own thread, where
the JAX package's copy of the class waits forever. One seed of the port's
chaos sweep, --schedule replay, in a process of its own.
"""

import collections
import functools
import queue
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu._private.ownership import TransitionRing as JTransitionRing
from ray_tpu.rllib.utils.replay import ReplayShardActor as JShard
from ray_tpu.rllib.utils.replay import route_shard as j_route_shard
from ray_tpu_torch._private.ownership import TransitionRing
from ray_tpu_torch.rllib.algorithms.dqn.dqn import (DQNConfig, DQNLearner,
                                                    DuelingQMLPModule)
from ray_tpu_torch.rllib.utils.device_feed import DeviceFeed, HostStage
from ray_tpu_torch.rllib.utils.replay import ReplayShardActor, route_shard


# ---- the ownership ring's repair ---------------------------------------

def _record_reentered_by_a_finalizer(ring_cls):
    """record() on a ring whose deque append drops the last reference to
    an object whose __del__ records again (as an ObjectRef.__del__ does
    through remove_local_ref -> decr_local -> transition -> record), on
    the same thread; returns whether that thread is still waiting after
    5 s, and the ring."""
    ring = ring_cls(maxlen=8)

    class Ref:
        def __del__(self):
            ring.record("object", "ref", "released", 1, 0)

    class FinalizingDeque(collections.deque):
        victims = [Ref()]

        def append(self, rec):
            self.victims.clear()   # the collection runs Ref.__del__ here
            super().append(rec)

    ring._ring = FinalizingDeque(maxlen=8)
    t = threading.Thread(target=ring.record,
                         args=("object", "ref", "added", 0, 1), daemon=True)
    t.start()
    t.join(5)
    return t.is_alive(), ring


def test_transition_ring_survives_reentry_from_a_finalizer():
    hung, _ = _record_reentered_by_a_finalizer(JTransitionRing)
    assert hung, "the unrepaired ring should wait on its own lock"
    hung, ring = _record_reentered_by_a_finalizer(TransitionRing)
    assert not hung
    events = [t["event"] for t in ring.snapshot()["transitions"]]
    assert sorted(events) == ["added", "released"]


# ---- routing and shards, bit for bit ------------------------------------

def test_route_shard_equals_jax():
    for n in (1, 2, 3, 8):
        keys = [f"{w}:{s}" for w in range(6) for s in range(40)]
        assert [route_shard(k, n) for k in keys] == \
            [j_route_shard(k, n) for k in keys]


def _push(rng, n):
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": rng.standard_normal(n).astype(np.float32)}


def test_shard_drops_stale_tickets_as_jax():
    """The same pushes (wrapping the ring between a sample and its
    priority update, so that the update's tickets are stale), samples and
    updates: the same batches, applied counts and stats."""
    ours = ReplayShardActor(1, 32, prioritized=True, seed=5, group="t")
    theirs = JShard(1, 32, prioritized=True, seed=5, group="t")
    rng = np.random.default_rng(0)
    for step in range(5):
        batch = _push(rng, 20)
        assert ours.push(batch) == theirs.push(batch)
        got, want = ours.sample(8, 0.4, 1), theirs.sample(8, 0.4, 1)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if step % 2:
            extra = _push(rng, 20)   # recycles the sampled slots
            ours.push(extra)
            theirs.push(extra)
        pri = np.abs(rng.standard_normal(8))
        assert ours.update_priorities(got["batch_indexes"], pri,
                                      got["item_epochs"]) == \
            theirs.update_priorities(want["batch_indexes"], pri,
                                     want["item_epochs"])
    assert ours.stats() == theirs.stats()
    assert ours.stats()["unmatched_priority_updates"] > 0
    assert ours.sample(64, 0.4, 1) is None   # below the gate


def test_staged_batch_as_dict_and_the_stall_bucket():
    """A staged batch reads back as numpy views (the path with no local
    learner); a DeviceFeed's blocked get() charges the bucket it names."""
    from ray_tpu_torch._private import goodput
    rng = np.random.default_rng(1)
    batch = _push(rng, 16)
    stage = HostStage(2, "cpu")
    staged = stage.assemble([batch], lambda k: 0)
    view = staged.as_dict()
    for k, v in batch.items():
        assert isinstance(view[k], np.ndarray) and view[k].dtype == v.dtype
        np.testing.assert_array_equal(view[k], v)
    staged.release()
    host: "queue.Queue" = queue.Queue()
    feed = DeviceFeed(host, "cpu", stall_bucket="replay_stall")
    got = {}

    def consume():   # on a thread of its own, bound to its own ledger
        ledger = goodput.ledger("replay-test").bind()
        try:
            feed.get(timeout=0.05)
        except queue.Empty:
            got["empty"] = True
        host.put((stage.assemble([batch], lambda k: 0), {"shard_id": 0}))
        got["cols"], got["meta"] = feed.get(timeout=10)
        got["totals"] = ledger.totals()

    try:
        t = threading.Thread(target=consume)
        t.start()
        t.join(30)
        assert not t.is_alive()
    finally:
        feed.stop()
    assert got["empty"] and got["meta"] == {"shard_id": 0}
    assert torch.equal(got["cols"]["obs"], torch.from_numpy(batch["obs"]))
    assert got["totals"]["replay_stall"] > 0.0
    assert got["totals"]["feed_stall"] == 0.0


# ---- on the port's runtime ----------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_dqn_trains_through_two_shards(cluster):
    """tests/test_replay_plane.py's two-shard DQN run on the port: env
    runners push to prioritized shards, the learner thread trains off
    the DeviceFeed, and TD-error priorities flow back to the shards."""
    from ray_tpu_torch.util import state
    algo = (DQNConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=1, rollout_fragment_length=32)
            .training(buffer_size=2000, train_batch_size=16,
                      num_steps_sampled_before_learning_starts=32,
                      target_network_update_freq=200,
                      prioritized_replay=True, num_replay_shards=2,
                      replay_shard_capacity=500)
            .learners(device="cpu").debugging(seed=0).build())
    try:
        result = {}
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            result = algo.train()
            if result["num_env_steps_trained_total"] > 0 and \
                    result["replay"]["priority_updates_sent"] > 0:
                break
        rep = result["replay"]
        assert result["num_env_steps_trained_total"] > 0, result
        assert rep["batches_pulled"] > 0, rep
        assert rep["priority_updates_sent"] > 0, rep
        assert rep["healthy_shards"] == 2, rep
        assert result["device_feed"]["batches_fed"] > 0, result
        assert "qf_loss" in result["learner"]
        shards = algo._replay_group.shard_stats()
        assert sum(s["added"] for s in shards) > 0, shards
        view = state.replay_shards()
        assert view["num_alive"] == 2 and view["total_added"] > 0, view
    finally:
        algo.stop()


def test_two_rank_gloo_dqn_update_equals_one_rank(cluster):
    """A 2-rank gloo learner gang and a local learner, each from the same
    seed, update on the same batch: the same params, the same scalar
    stats, and every row's td_error (the gang's in rank order, matched
    by td_indexes); a target sync reaches every rank."""
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
    lr = 1e-3
    cfg = DQNConfig().training(lr=lr).learners(device="cpu")
    module = DuelingQMLPModule(4, 2, (32, 32))
    rng = np.random.default_rng(3)
    n = 32
    batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32),
             "rewards": rng.standard_normal(n).astype(np.float32),
             "dones": (rng.random(n) < 0.2).astype(np.float32),
             "discounts": np.full(n, 0.99, np.float32),
             "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
             "weights": rng.uniform(0.3, 1.0, n).astype(np.float32),
             "batch_indexes": np.arange(100, 100 + n, dtype=np.int64)}
    local = DQNLearner(module, cfg)
    local.build(seed=0)
    want = local.update(batch, None, 1, seed=7)
    group = LearnerGroup(functools.partial(DQNLearner, module, cfg),
                         num_learners=2, seed=0)
    try:
        got = group.update(batch, None, 1, seed=7)
        for k in ("qf_loss", "mean_q", "mean_td_error", "total_loss",
                  "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
        order = np.argsort(got["td_indexes"])
        np.testing.assert_array_equal(got["td_indexes"][order],
                                      np.sort(want["td_indexes"]))
        np.testing.assert_allclose(
            got["td_error"][order],
            want["td_error"][np.argsort(want["td_indexes"])], rtol=1e-5,
            atol=1e-6)
        weights = group.get_weights()
        for k, v in local.get_weights().items():
            np.testing.assert_allclose(weights[k], v, rtol=1e-5,
                                       atol=1e-5 * lr, err_msg=k)
        group.additional_update(update_target=True)
        states = ray_tpu_torch.get([a.get_state.remote()
                                    for a in group._actors], timeout=120)
        for s in states:
            for k, v in s["params"].items():
                np.testing.assert_array_equal(s["target_params"][k], v)
    finally:
        group.shutdown()


# ---- the port's chaos sweep, --schedule replay ---------------------------------

def test_chaos_sweep_replay_smoke():
    """tests/test_replay_plane.py's one-seed replay drill on the port: a
    shard killed after 10 pushes and RPC delays and drops, through which
    DQN keeps training (python -m ray_tpu_torch.tools.chaos_sweep, the
    learner on the CPU)."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.chaos_sweep",
         "--schedule", "replay", "--device", "cpu", "--format", "json",
         "--seeds", "1", "--timeout", "300"],
        capture_output=True, text=True, timeout=420, cwd=repo)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert lines, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(lines[-1])
    assert out["schedule"] == "replay"
    assert out["failed_seeds"] == [], out
    assert out["results"][0]["fired"] >= 1
