"""IMPALA through a 2-rank gloo learner gang against a local learner, on
the CPU, through the algorithm's own learner thread.

Two Impala algorithms are built from one CartPole config (seed 0, lr
1e-2, no grad clip), one with `learners(num_learners=2)` on the CPU,
one with a local learner. The same runner fragments (numpy, seeded) go
into each one's fresh buffer and through `_maybe_enqueue_batch` to its
learner thread: the gang's plain concatenated batch over the object
store, the local learner's staged one through its DeviceFeed. After one
update of one [T, B] batch the gang's stats equal the local learner's
(its first update returns its own: rtol 1e-5, the bar of
tests/test_torch_rllib.py), the weights of each rank are equal to the
bit, and rank 0's are within 1e-6 of the local learner's. B = 8 splits
4 + 4 over the ranks; B = 5 splits 2 + 3, every column training, each
rank's grads weighed by its share (a gang that drops the remainder, or
weighs the ranks alike, moves the weights ~lr away).
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.rllib import ImpalaConfig

T, LR, WEIGHT_ATOL = 6, 1e-2, 1e-6


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _fragments(rng, cols):
    """One time-major fragment a column group: CartPole's shapes in the
    learner's columns (impala._to_timemajor)."""
    return [{
        "obs": rng.standard_normal((T, c, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, c)).astype(np.int32),
        "rewards": rng.standard_normal((T, c)).astype(np.float32),
        "dones": rng.random((T, c)) < 0.1,
        "behaviour_logp": (-0.69 + 0.3 * rng.standard_normal((T, c))
                           ).astype(np.float32),
        "bootstrap_value": rng.standard_normal(c).astype(np.float32),
    } for c in cols]


def _one_update(num_learners, cols):
    """(the learner thread's stats, every rank's weights) after one
    update of the fragments' batch."""
    config = (ImpalaConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=0)
              .training(lr=LR, grad_clip=None, train_batch_size=T * sum(cols))
              .learners(num_learners=num_learners, device="cpu")
              .debugging(seed=0))
    algo = config.build()
    try:
        algo._ensure_learner_thread()
        for f in _fragments(np.random.default_rng(0), cols):
            algo._fresh.append(f)
            algo._fresh_steps += f["actions"].size
        assert algo._maybe_enqueue_batch() == T * sum(cols)
        deadline = time.time() + 60
        while algo._updates_done < 1:
            assert algo._learner_error is None, algo._learner_error
            assert time.time() < deadline, "the learner thread did not update"
            time.sleep(0.02)
        group = algo.learner_group
        if num_learners:
            weights = ray_tpu_torch.get(
                [a.get_weights.remote() for a in group._actors], timeout=60)
        else:
            weights = [group.get_weights()]
        with algo._stats_lock:
            return dict(algo._learner_stats), weights, algo._steps_trained
    finally:
        algo.stop()


@pytest.mark.parametrize("cols", [(4, 4), (2, 3)], ids=["B8", "B5"])
def test_impala_gang_update_equals_local_learner(cluster, cols):
    s_gang, w_gang, trained = _one_update(2, cols)
    s_local, (w_local,), _ = _one_update(0, cols)
    assert trained == T * sum(cols)
    assert set(s_gang) == set(s_local)
    for k in ("total_loss", "policy_loss", "vf_loss", "entropy",
              "grad_norm"):
        np.testing.assert_allclose(s_gang[k], s_local[k], rtol=1e-5,
                                   err_msg=k)
    assert len(w_gang) == 2 and set(w_gang[0]) == set(w_local)
    for k in w_local:
        assert np.array_equal(w_gang[0][k], w_gang[1][k]), k
    diff = max(float(np.max(np.abs(w_local[k] - w_gang[0][k])))
               for k in w_local)
    moved = max(float(np.max(np.abs(w_local[k] - w0)))
                for k, w0 in _initial_weights().items())
    assert moved > 100 * WEIGHT_ATOL, moved
    assert diff < WEIGHT_ATOL, f"gang diverged from the local learner: {diff}"


def _initial_weights():
    config = (ImpalaConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=0).learners(device="cpu")
              .debugging(seed=0))
    algo = config.build()
    try:
        return algo.learner_group.get_weights()
    finally:
        algo.stop()
