"""The port's RL benchmark (ray_tpu_torch/tools/bench_rl.py, an edited
copy of the JAX package's tools/bench_rl.py: the learners run on
--device, the card by default) on the CPU.

`--device cpu --seconds 1` runs of PPO CartPole and of IMPALA MiniPong,
each in a process of its own, started together when the module's first
test runs: each prints the keys the reference's result dicts hold (read
from its source: running it compiles JAX learners for minutes), the
IMPALA key under the port's name, and the learner-only updates run. With
no device the tool resolves to the card and raises without one.
"""

import ast

import pytest

from _torch_bench_procs import REPO, finish, import_alone, last_json, start
from ray_tpu_torch.tools import bench_rl

TIMEOUT_S = 150
# the reference's result key -> the port's (the learner on the card)
CONFIGS = {"ppo": ("ppo_cartpole_single_learner", "bench_ppo_cartpole"),
           "impala": ("impala_minipong_gpu_learner",
                      "bench_impala_minipong")}


def reference_keys(function, name="result"):
    """The keys function `function` of tools/bench_rl.py gives the dict
    `name`: its literal's and those assigned one by one."""
    tree = ast.parse((REPO / "tools" / "bench_rl.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == function)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == name \
                        and isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys}
                if isinstance(target, ast.Subscript) and isinstance(
                        target.value, ast.Name) and target.value.id == name:
                    keys.add(target.slice.value)
    return keys


@pytest.fixture(scope="module")
def runs():
    procs = {only: start(["-m", "ray_tpu_torch.tools.bench_rl", "--device",
                          "cpu", "--seconds", "1", "--only", only])
             for only in CONFIGS}
    out = {}
    for only, proc in procs.items():
        rc, stdout, err = finish(proc, TIMEOUT_S)
        assert rc == 0, f"{only}: rc={rc}\n{stdout[-2000:]}\n{err[-3000:]}"
        out[only] = last_json(stdout)
    yield out


@pytest.mark.parametrize("only", list(CONFIGS))
def test_keys_equal_the_reference(runs, only):
    doc = runs[only]
    assert set(doc) == reference_keys("main", "results")
    assert doc["suite"] == "rl_north_star_on_chip"
    assert doc["platform"] == "cpu" and doc["devices"] == ["cpu"]
    key, function = CONFIGS[only]
    (row,) = doc["results"].values()
    assert list(doc["results"]) == [key]
    assert set(row) == reference_keys(function)
    assert row["platform"] == "cpu"


def test_ppo_trains(runs):
    row = runs["ppo"]["results"]["ppo_cartpole_single_learner"]
    assert row["iterations"] >= 1 and row["env_steps_total"] > 0, row
    assert row["learner_updates_per_sec"] > 0, row


def test_impala_trains_and_its_learner_alone_updates(runs):
    row = runs["impala"]["results"]["impala_minipong_gpu_learner"]
    assert row["env_steps_trained"] > 0 and row["learner_updates"] > 0, row
    assert row["learner_only_updates_per_sec"] > 0, row
    assert 0 <= row["feed_stall_pct"] <= 100, row


def test_no_device_is_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_rl._platform(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_rl.main(["--only", "ppo", "--seconds", "0"])


def test_imports_alone_without_jax():
    rc, out = import_alone("ray_tpu_torch.tools.bench_rl")
    assert rc == 0 and "BAD []" in out, out
