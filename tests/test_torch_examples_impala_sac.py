"""The port's rllib_impala_minipong and rllib_sac_pendulum examples at a
small depth, their learners on device="cpu" (the two scripts whose
environments the card's machine lacks: MiniPong's runners need no
gymnasium, Pendulum-v1 is gymnasium's).

Their output rests on sampling streams that the packages do not share,
so nothing is compared with the JAX scripts' numbers: IMPALA's two
runner actors feed its learner for 2 s, each train() prints a line, and
each reward mean once episodes have ended lies in [-3, 3] (MiniPong's
returns with max_returns 3); SAC's 41 iterations (learning starts at
1,000 sampled steps) print iterations 0 and 40, and by 40 its entropy
temperature has moved off its initial 1.0, down (a learning signal).
"""

import re

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.examples import rllib_impala_minipong, rllib_sac_pendulum


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_impala_minipong_runs_its_clock(capsys):
    rllib_impala_minipong.main(seconds=2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    rewards = [float(m.group(1)) for x in lines for m in
               [re.match(r"^t= *\d+s reward_mean=(\S+)$", x)] if m]
    assert rewards, lines
    # nan until a runner's first episode ends (on a loaded box, none may
    # within the clock)
    assert all(-3.0 <= r <= 3.0 for r in rewards if r == r), rewards
    assert not ray_tpu_torch.is_initialized()


def test_sac_pendulum_tunes_its_temperature(capsys):
    rllib_sac_pendulum.main(iterations=41, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    rows = [re.match(r"^iter +(\d+) reward +(\S+) alpha (\S+)$", x).groups()
            for x in lines if x.startswith("iter")]
    assert [int(r[0]) for r in rows] == [0, 40], lines
    reward, alpha = float(rows[1][1]), float(rows[1][2])
    assert -2000.0 < reward < 0.0, rows
    assert 0.0 < alpha < 1.0, rows
