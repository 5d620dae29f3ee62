"""The port's examples are the JAX package's scripts: each of the 14 in
examples/ has its counterpart in ray_tpu_torch/examples/, and the README
there lists each. Twelve are copies under the rename rule (the one
tests/test_torch_runtime.py applies) with only the edits EDITS names:
keyword arguments on main() for depth, `.learners(device=device)` where
an RLlib learner runs, and the "Run:" lines of docstrings. The two that
import jax (train_gpt2_jax.py, multislice_mesh.py) are rewritten over
the port's TorchTrainer and parallel/multislice.py: they have their own
tests (test_torch_examples_gpt2.py, test_torch_examples_data_mesh.py).
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_runtime import rename  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ray_tpu_torch" / "examples"

# the JAX scripts rewritten for the port: reference name -> the port's
REWRITTEN = {"train_gpt2_jax": "train_gpt2_torch",
             "multislice_mesh": "multislice_mesh"}

# what an RLlib script adds to each algorithm's config chain
LEARNERS = ".learners(device=device)"


def _build(indent, seed):
    """The edit that puts the learners on main()'s device before
    .build()."""
    return (f"{indent}.debugging(seed={seed})\n{indent}.build())",
            f"{indent}.debugging(seed={seed})\n{indent}{LEARNERS}\n"
            f"{indent}.build())")


# name -> its edits, (reference text under the rename rule, the port's)
EDITS = {
    "core_tasks_actors": [],
    "data_pipeline": [],
    "serve_inference": [],
    "tune_pbt_sweep": [],
    "serve_streaming_multiplex": [
        ("Run: python examples/serve_streaming_multiplex.py",
         "Run: python -m ray_tpu_torch.examples.serve_streaming_multiplex")],
    "tune_tpe_search": [
        ("Run: python examples/tune_tpe_search.py",
         "Run: python -m ray_tpu_torch.examples.tune_tpe_search"),
        ("def main() -> None:", "def main(num_samples=20) -> None:"),
        ('metric="score", mode="max", num_samples=20,',
         'metric="score", mode="max", num_samples=num_samples,')],
    "rllib_ppo_cartpole": [
        ("def main():", "def main(iterations=40, device=None):"),
        _build(" " * 12, 7),
        ("    for i in range(40):", "    for i in range(iterations):")],
    "rllib_offline_bc": [
        ("def main():",
         "def main(collect_iterations=15, bc_iterations=30, device=None):"),
        _build(" " * 17, 7),
        ("    for i in range(15):", "    for i in range(collect_iterations):"),
        _build(" " * 10, 0),
        ("    for i in range(30):", "    for i in range(bc_iterations):")],
    "rllib_multi_agent_policies": [
        ("Run (chip-free):\n    JAX_PLATFORMS=cpu python "
         "examples/rllib_multi_agent_policies.py",
         "Run:\n    python -m ray_tpu_torch.examples.rllib_multi_agent_policies"),
        ("def main() -> None:", "def main(iterations=20, device=None) -> None:"),
        _build(" " * 12, 0),
        ("    for i in range(20):", "    for i in range(iterations):")],
    "rllib_connectors_pixels": [
        ("Run (chip-free):\n    JAX_PLATFORMS=cpu python "
         "examples/rllib_connectors_pixels.py",
         "Run:\n    python -m ray_tpu_torch.examples.rllib_connectors_pixels"),
        ("def main() -> None:", "def main(iterations=5, device=None) -> None:"),
        _build(" " * 12, 0),
        ("    for i in range(5):", "    for i in range(iterations):")],
    "rllib_impala_minipong": [
        ("Run: PYTHONPATH=. python examples/rllib_impala_minipong.py",
         "Run: python -m ray_tpu_torch.examples.rllib_impala_minipong"),
        ("def main() -> None:", "def main(seconds=900, device=None) -> None:"),
        ("              .debugging(seed=0))",
         f"              .debugging(seed=0)\n              {LEARNERS})"),
        ("        while time.time() - t0 < 900:",
         "        while time.time() - t0 < seconds:")],
    "rllib_sac_pendulum": [
        ("def main():", "def main(iterations=800, device=None):"),
        _build(" " * 12, 0),
        ("    for i in range(800):", "    for i in range(iterations):")],
}


def test_every_reference_example_has_its_counterpart():
    ref = sorted(p.stem for p in (REPO / "examples").glob("*.py"))
    assert len(ref) == 14
    assert sorted(list(EDITS) + list(REWRITTEN)) == ref
    port = sorted(p.stem for p in PORT.glob("*.py") if p.stem != "__init__")
    assert port == sorted(list(EDITS) + list(REWRITTEN.values()))
    readme = (PORT / "README.md").read_text()
    for name in port:
        assert f"`{name}.py`" in readme, name


@pytest.mark.parametrize("name", sorted(EDITS))
def test_example_is_the_reference_under_the_rename_rule(name):
    want = rename((REPO / "examples" / f"{name}.py").read_text())
    for before, after in EDITS[name]:
        assert want.count(before) == 1, (name, before)
        want = want.replace(before, after)
    assert (PORT / f"{name}.py").read_text() == want

