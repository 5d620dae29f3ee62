"""The port's on-policy and offline RLlib examples at a small depth, their
learners on device="cpu": rllib_ppo_cartpole, rllib_offline_bc,
rllib_multi_agent_policies and rllib_connectors_pixels, each main()
called in this process (they sample locally, with no cluster).

Their output rests on sampling streams that the packages do not share,
so nothing is compared with the JAX scripts' numbers: each test holds
the lines a script prints, the state it leaves (a checkpoint, recorded
offline data) and, where a few iterations show one, a learning signal
(PPO CartPole's seeded reward rising over 6 iterations).
"""

import re
import tempfile

import numpy as np
import pytest
import torch

from ray_tpu_torch.examples import (rllib_connectors_pixels,
                                    rllib_multi_agent_policies,
                                    rllib_offline_bc, rllib_ppo_cartpole)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture()
def tmp(tmp_path, monkeypatch):
    """The scripts' tempfile.mkdtemp() directories, under tmp_path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _floats(lines, pattern):
    return [float(m.group(1)) for line in lines
            for m in [re.search(pattern, line)] if m]


def test_ppo_cartpole_learns_and_saves(capsys, tmp):
    rllib_ppo_cartpole.main(iterations=6, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    rewards = _floats(lines, r"^iter +\d+ reward +(\S+)$")
    assert len(rewards) == 6, lines
    assert rewards[-1] > rewards[0] + 10, rewards
    (ckpt,) = [x for x in lines if x.startswith("checkpoint:")]
    (saved,) = list(tmp.glob("ppo_ckpt_*"))
    assert ckpt == f"checkpoint: {saved}" and any(saved.iterdir())


def test_offline_bc_records_then_clones(capsys, tmp):
    rllib_offline_bc.main(collect_iterations=2, bc_iterations=2,
                          device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(_floats(lines, r"^collector reward: (\S+)$")) == 1, lines
    assert len([x for x in lines if x.startswith("bc iter  0 eval reward")]
               ) == 1, lines
    (data,) = list(tmp.glob("offline_data_*"))
    files = sorted(p.name for p in data.iterdir())
    assert files and all(f.endswith(".jsonl") for f in files), files


def test_multi_agent_policies_train_both(capsys):
    rllib_multi_agent_policies.main(iterations=2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    pat = (r"^iter +\d+ return= *(\S+) left_loss=(\S+) "
           r"right_loss=(\S+)$")
    rows = [re.match(pat, x).groups() for x in lines if x.startswith("iter")]
    assert len(rows) == 2, lines
    vals = np.array(rows, dtype=float)
    assert np.isfinite(vals).all()
    # two distinct policies, each with its own loss
    assert (vals[:, 1] != vals[:, 2]).all()


def test_connectors_pixels_build_on_the_pipeline_space(capsys):
    rllib_connectors_pixels.main(iterations=1, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "module observation space: (84, 84, 4)", lines
    assert re.match(r"^iter 0 trained=256 return=\S+$", lines[1]), lines
