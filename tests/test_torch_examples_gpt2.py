"""The port's GPT-2 example (the counterpart of examples/train_gpt2_jax.py)
at TINY through a CPU TorchTrainer (use_gpu=False, gloo).

The JAX script draws its weights and tokens from jax.random, which the
port does not share, so the two runs' losses are not compared: the test
holds the structure of what the loop reports (a step and a finite loss
each step, the reference's 10 steps by default), a learning signal (the
first loss near ln(vocab) + 0.5, TINY's untied head scaling its logits
to unit variance; the loss falling), that the loop trains the model and
for the steps its config names, and that main() asks for the card unless
told otherwise.
"""

import math

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.examples import train_gpt2_torch
from ray_tpu_torch.models import TINY


@pytest.fixture()
def home(tmp_path, monkeypatch):
    # RunConfig's default storage is under ~/ray_tpu_results
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


def test_main_trains_tiny_and_reports_each_step(home, capsys):
    result = train_gpt2_torch.main(device="cpu")
    assert result.error is None, result.error
    history = result.metrics_history
    assert [m["step"] for m in history] == list(range(10))
    losses = [m["loss"] for m in history]
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - (math.log(TINY.vocab_size) + 0.5)) < 0.5, losses
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert result.metrics == history[-1]
    out = capsys.readouterr().out
    assert f"final: {history[-1]}" in out
    assert (home / "ray_tpu_results" / "gpt2_tiny_demo").is_dir()
    assert not ray_tpu_torch.is_initialized()


def test_loop_reads_model_and_steps_from_its_config(home):
    """A TransformerConfig in place of a preset's name, and the steps."""
    narrow = TINY.replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1)
    result = train_gpt2_torch.main(model=narrow, steps=3, device="cpu")
    assert result.error is None, result.error
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2]
    assert all(math.isfinite(m["loss"]) for m in result.metrics_history)


def test_main_asks_for_the_card_by_default(monkeypatch):
    """device=None: the worker asks for a GPU (and the loop for CUDA);
    the CPU is only the caller's choice."""
    made = {}

    class Trainer:
        def __init__(self, loop, *, train_loop_config, scaling_config,
                     run_config):
            made.update(config=train_loop_config, scaling=scaling_config)

        def fit(self):
            from ray_tpu_torch.train import Result
            return Result(metrics={}, checkpoint=None)

    monkeypatch.setattr(train_gpt2_torch, "TorchTrainer", Trainer)
    monkeypatch.setattr(ray_tpu_torch, "init", lambda **kw: None)
    monkeypatch.setattr(ray_tpu_torch, "shutdown", lambda: None)
    train_gpt2_torch.main()
    assert made["scaling"].num_gpus_per_worker == 1
    assert made["config"] == {"steps": 10, "model": "TINY", "device": None}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ray_tpu_torch._device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(made["config"]["device"])
