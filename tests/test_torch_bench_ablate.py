"""The port's train-step ablation harness (ray_tpu_torch/tools/
bench_ablate.py, an edited copy of the JAX package's tools/bench_ablate.py:
its variants train the port's Transformer through make_train_step on
one device, the card by default) on the CPU.

The variant and lease tables are the reference's, read from
tools/bench_ablate.py (whose top level imports no JAX). At a narrow
width (NARROW, two steps each) best, best_noattn, best again, nohead
and best_sgd train: identity attention moves the loss and the second
best equals the first to the bit, so the attention hook came back. A
failing variant (and a variant with no device on a box without a card)
makes the tool exit 1, with the hook restored; passing ones exit 0.
`--suite lease --n 50` prints its three rows; it starts in a process of
its own when the module's first test runs. chip_tools.py reads the rows
of both as the tool prints them.
"""

import functools
import importlib.util
import math

import pytest

import ray_tpu_torch.models.transformer as tr
import chip_tools
from _torch_bench_procs import REPO, finish, import_alone, start
from ray_tpu_torch.models import GPT2_125M
from ray_tpu_torch.tools import bench_ablate

# 6 heads of 16 (12 of 8 for the reference's 12-head variants), 2 layers
NARROW = GPT2_125M.replace(d_model=96, n_layers=2, d_ff=192,
                           vocab_size=512, max_seq_len=64)
SEQUENCE = ("best", "best_noattn", "best", "nohead", "best_sgd")
TIMEOUT_S = 150


def _reference():
    spec = importlib.util.spec_from_file_location(
        "_reference_bench_ablate", REPO / "tools" / "bench_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lease():
    proc = start(["-m", "ray_tpu_torch.tools.bench_ablate", "--suite",
                  "lease", "--n", "50"])
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def narrow(lease):
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_ablate, "WARMUP", 1)
        mp.setattr(bench_ablate, "STEPS", 1)
        for name in SEQUENCE:
            knobs = dict(bench_ablate.VARIANTS[name], batch=2)
            rows.append(bench_ablate.run_variant(
                name, device="cpu", base=NARROW, **knobs))
    return rows


def test_variants_equal_the_reference():
    ref = _reference()
    assert bench_ablate.VARIANTS == ref.VARIANTS
    assert bench_ablate.LEASE_VARIANTS == ref.LEASE_VARIANTS
    assert (bench_ablate.BATCH, bench_ablate.WARMUP, bench_ablate.STEPS) \
        == (ref.BATCH, ref.WARMUP, ref.STEPS)


def test_reference_tool_imports_no_jax_at_its_top():
    rc, out = import_alone("tools.bench_ablate")
    assert rc == 0 and "BAD []" in out, out


def test_narrow_variants_train(narrow):
    for row in narrow:
        assert math.isfinite(row["loss"]) and row["steps"] == 2, row
        assert row["step_ms"] > 0, row
    best = narrow[0]["loss"]
    assert abs(best - math.log(NARROW.vocab_size)) < 0.5
    assert narrow[1]["loss"] != best          # identity attention
    assert narrow[4]["loss"] != best          # SGD, not AdamW


def test_attention_hook_restored_to_the_bit(narrow):
    assert narrow[2]["loss"] == narrow[0]["loss"]
    assert tr._attention_fn.__module__ == tr.__name__
    assert tr._attention_fn.__name__ == "_attention_fn"


def test_hook_restored_when_a_no_attn_variant_fails():
    hook = tr._attention_fn
    with pytest.raises(ValueError, match="attention_impl"):
        bench_ablate.run_variant("broken", device="cpu", base=NARROW,
                                 no_attn=True, attention_impl="bogus")
    assert tr._attention_fn is hook


def test_a_failing_variant_exits_nonzero(monkeypatch, capsys):
    hook = tr._attention_fn
    monkeypatch.setattr(bench_ablate, "WARMUP", 0)
    monkeypatch.setattr(bench_ablate, "STEPS", 1)
    monkeypatch.setattr(bench_ablate, "run_variant", functools.partial(
        bench_ablate.run_variant, device="cpu", base=NARROW))
    monkeypatch.setitem(bench_ablate.VARIANTS, "broken",
                        {"no_attn": True, "attention_impl": "bogus"})
    assert bench_ablate.main(["best", "best_noattn"]) == 0
    assert bench_ablate.main(["best", "broken"]) == 1
    out = capsys.readouterr().out
    assert "broken" in out and "FAILED: ValueError" in out
    assert tr._attention_fn is hook
    rows = chip_tools.parse("bench_ablate", out)
    assert sorted(rows) == ["best", "best_noattn"]
    assert all(math.isfinite(r["loss"]) for r in rows.values()), rows


def test_no_device_is_the_card_and_fails_without_one(capsys):
    assert bench_ablate.main(["best"]) == 1
    assert "FAILED: RuntimeError" in capsys.readouterr().out


def test_lease_suite_prints_its_three_rows(lease):
    rc, out, err = finish(lease, TIMEOUT_S)
    assert rc == 0, f"rc={rc}\n{out[-2000:]}\n{err[-3000:]}"
    rows = [line.split()[0] for line in out.splitlines()
            if "tasks/s" in line]
    assert rows == [name for name, _, _ in bench_ablate.LEASE_VARIANTS]
    parsed = chip_tools.parse("lease", out)
    assert list(parsed) == rows
    assert all(r["n"] == 50 and r["tasks_per_sec"] > 0
               for r in parsed.values()), parsed


def test_imports_alone_without_jax():
    rc, out = import_alone("ray_tpu_torch.tools.bench_ablate")
    assert rc == 0 and "BAD []" in out, out
