"""The kernel check of chip_smoke.py, on the CPU: it accepts outputs that
carry the kernels' own rounding (P and dS rounded to bf16 before their
products, bf16 outputs) and rejects a kernel that drops the ragged last
V tile from the product while keeping its keys in the softmax sum. dq's
query row 0, zero in exact arithmetic, is held to its rounding bound:
a dQ summed as the kernel sums it passes at any seed, and ordinary values
planted on that row fail. Phase "serve"'s scoring gives a padded prompt
its own forward's answer, and its bars accept and reject as stated.
Phase "ops"'s answers keep their values through the numpy form they
cross the thin client's proxy in, and its process reader finds a line,
fails on an early exit and ends a process with SIGTERM. Phase
"elastic"'s checks of the ranks' records accept a 2 -> 1 -> 2 drill and
reject each fault they name. Phase "examples" runs last; its checks of
the GPT-2 example's reports accept a run (with and without remat) and
reject each fault they name, and its wrapper of the example's loop adds
the launches, the time and the peak memory to each report."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as pflash

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B, T, H, D = 1, 200, 2, 64   # T ragged against the kernels' 64-row tiles
TILE = 64


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _outputs():
    """Plain f32 outputs and outputs with the kernels' rounding, [B,T,H,D]."""
    rng = np.random.default_rng(0)
    q, k, v, do = (_bf16(torch.from_numpy(rng.standard_normal(
        (B, T, H, D)).astype(np.float32))) for _ in range(4))
    scale = D ** -0.5
    o_ref, lse = pflash.flash_fwd_ref(q, k, v, scale, True)
    di = pflash.row_dot(o_ref, do)
    dk_ref, dv_ref = pflash.flash_bwd_dkv_ref(q, k, v, do, lse, di, scale, True)
    dq_ref = pflash.flash_bwd_dq_ref(q, k, v, do, lse, di, scale, True)

    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))  # [B,H,T,D]
    s = (qh @ kh.transpose(-1, -2)) * scale
    keep = torch.ones(T, T, dtype=torch.bool).tril()
    s = s.masked_fill(~keep, float("-inf"))
    pu = torch.exp(s - s.amax(-1, keepdim=True))   # unnormalised, as online
    rows = pu.sum(-1, keepdim=True)
    o = _bf16((_bf16(pu) @ vh) / rows)
    v_cut = vh.clone()
    v_cut[:, :, T // TILE * TILE:] = 0.0           # the planted fault
    o_fault = _bf16((_bf16(pu) @ v_cut) / rows)
    p = torch.exp(s - lse[..., None])
    dv = _bf16(_bf16(p).transpose(-1, -2) @ doh)
    ds = _bf16(p * (doh @ vh.transpose(-1, -2) - di[..., None]))
    dk = _bf16(ds.transpose(-1, -2) @ qh * scale)
    dq = _bf16(ds @ kh * scale)
    back = lambda x: x.transpose(1, 2)             # noqa: E731
    dq_floor = chip_smoke.dq_row_floor(torch, pflash, q, k, v, do, o_ref, lse,
                                       scale, True)
    return {"o": (back(o), o_ref, None), "dk": (back(dk), dk_ref, None),
            "dv": (back(dv), dv_ref, None), "dq": (back(dq), dq_ref, dq_floor),
            "o_fault": (back(o_fault), o_ref, None)}


@pytest.fixture(scope="module")
def outputs():
    return _outputs()


@pytest.mark.parametrize("out", ["o", "dk", "dv", "dq"])
def test_check_accepts_kernel_rounding(outputs, out):
    a, ref, floor = outputs[out]
    # well inside the allowance, so the card's ~60000x more elements
    # (the largest of them a few sigma further out) still fit
    assert chip_smoke.excess(a, ref, floor) < 0.5


def test_check_rejects_ragged_v_fault(outputs):
    a, ref, floor = outputs["o_fault"]
    assert chip_smoke.excess(a, ref, floor) > 2.0


def test_check_fails_on_nan():
    ref = torch.ones(1, 4, 1, 8)
    a = ref.clone()
    a[0, 1, 0, 3] = float("nan")
    assert not chip_smoke.excess(a, ref) <= 1.0


def test_check_rejects_ordinary_values_on_the_zero_row(outputs):
    a, ref, floor = outputs["dq"]
    assert ref[:, 0].abs().max() < 1e-5     # zero in exact arithmetic
    bad = a.clone()
    bad[:, 0] = a[:, T // 2]
    assert chip_smoke.excess(bad, ref, floor) > 2.0
    bad[:, 0] = 0.01 * a[:, T // 2]         # still far above its rounding
    assert chip_smoke.excess(bad, ref, floor) > 1.0


def _dq_kernel_like(seed, b=1, t=384, h=2, d=128, step=16):
    """(dq as the kernel computes it, plain dq, its row floor) at one seed:
    S and dP summed in 16-deep steps, P by exp2 in log2 units, dS rounded
    to bf16, dQ summed in 16-key steps and rounded to bf16."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(torch.from_numpy(rng.standard_normal(
        (b, t, h, d)).astype(np.float32))) for _ in range(4))
    scale = d ** -0.5
    o_ref, lse = pflash.flash_fwd_ref(q, k, v, scale, True)
    di = pflash.row_dot(o_ref, do)
    dq_ref = pflash.flash_bwd_dq_ref(q, k, v, do, lse, di, scale, True)
    floor = chip_smoke.dq_row_floor(torch, pflash, q, k, v, do, o_ref, lse,
                                    scale, True)
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    chunks = lambda x, y: sum(                     # noqa: E731
        x[..., i:i + step] @ y[..., i:i + step].transpose(-1, -2)
        for i in range(0, d, step))
    log2e = 1.4426950408889634
    p = torch.exp2(chunks(qh, kh) * (scale * log2e) - lse[..., None] * log2e)
    p = p.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), 0.0)
    ds = _bf16(p * (chunks(doh, vh) - di[..., None]))
    dq = sum(ds[..., j:j + step] @ kh[..., j:j + step, :]
             for j in range(0, t, step))
    return _bf16(dq * scale).transpose(1, 2), dq_ref, floor


@pytest.mark.parametrize("seed", range(6))
def test_check_accepts_kernel_like_dq_at_any_seed(seed):
    dq, ref, floor = _dq_kernel_like(seed)
    assert chip_smoke.excess(dq, ref, floor) < 0.5
    # the zero row: the kernel's own rounding stays far inside its bound
    assert chip_smoke.excess(dq[:, :1], ref[:, :1], floor[:, :1]) < 0.1


def _serve_model():
    from ray_tpu_torch.models import TINY, Transformer
    torch.manual_seed(0)
    return Transformer(TINY.replace(dtype="float32"), device="cpu", seed=0)


def test_serve_scores_of_a_padded_batch_are_each_prompt_alone():
    """Phase "serve"'s scoring: right-padding a prompt to the batch's
    longest leaves its answer as its own forward's, and the answer is
    the log-softmax of its logits."""
    model = _serve_model()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n) for n in (5, 33, 17)]
    batched = chip_smoke.score_prompts(torch, model, prompts)
    for p, got in zip(prompts, batched):
        alone = chip_smoke.score_prompts(torch, model, [p])[0]
        assert got["next_token"] == alone["next_token"]
        np.testing.assert_allclose(
            [got["logprob_sum"], got["next_logprob"], got["gap"]],
            [alone["logprob_sum"], alone["next_logprob"], alone["gap"]],
            rtol=1e-5, atol=1e-5)  # the gap: a difference of two logits
        with torch.no_grad():
            logp = torch.log_softmax(
                model(torch.as_tensor(p)[None]).double(), -1)[0]
        np.testing.assert_allclose(
            got["logprob_sum"],
            float(logp[:-1].gather(-1, torch.as_tensor(p[1:])[:, None])
                  .sum()), rtol=1e-5)
        assert got["next_token"] == int(logp[-1].argmax())


def test_serve_check_scores_bars():
    """The served answers' bars: a log-prob sum within SERVE_TOKEN_TOL a
    token passes and one beyond fails; a different argmax fails where
    the direct top-2 gap is SERVE_GAP or more and is not held below."""
    want = {"logprob_sum": -100.0, "next_token": 7, "next_logprob": -2.0,
            "gap": chip_smoke.SERVE_GAP, "tokens": 11}
    bar = chip_smoke.SERVE_TOKEN_TOL * 10
    ok = dict(want, logprob_sum=-100.0 + 0.9 * bar)
    assert chip_smoke.check_scores([ok], [want], "t") == (
        pytest.approx(0.9 * chip_smoke.SERVE_TOKEN_TOL), 1)
    with pytest.raises(AssertionError, match="logprob_sum"):
        chip_smoke.check_scores([dict(want, logprob_sum=-100.0 - 1.1 * bar)],
                                [want], "t")
    with pytest.raises(AssertionError, match="next token"):
        chip_smoke.check_scores([dict(want, next_token=8)], [want], "t")
    near = dict(want, gap=0.5 * chip_smoke.SERVE_GAP)
    assert chip_smoke.check_scores([dict(want, next_token=8)], [near],
                                   "t")[1] == 0


def test_ops_scores_survive_their_numpy_form():
    """Phase "ops": score_array's [rows, 3] float64 form, read back by
    array_scores, gives the answers check_scores held before."""
    model = _serve_model()
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 256, (3, 24))
    direct = [{**chip_smoke.score_prompts(torch, model, [r])[0],
               "tokens": len(r)} for r in rows]
    arr = chip_smoke.score_array(chip_smoke.score_prompts(torch, model,
                                                          list(rows)))
    assert arr.shape == (3, 3) and arr.dtype == np.float64
    back = chip_smoke.array_scores(arr)
    assert [b["next_token"] for b in back] == \
        [d["next_token"] for d in direct]
    worst, _ = chip_smoke.check_scores(back, direct, "row")
    assert worst <= 1e-5


def test_ops_process_reader(tmp_path):
    """OpsProc: wait_for returns the first line with the prefix and when
    it came, raises when the process exits first, and end() stops a
    process with SIGTERM."""
    import signal
    import sys
    import time

    code = ("import sys, time\nprint('noise', flush=True)\n"
            "print('READY 7', flush=True)\ntime.sleep(60)\n")
    proc = chip_smoke.OpsProc([sys.executable, "-c", code], None, "sleeper")
    t0 = time.time()
    assert proc.wait_for("READY", 60) == "READY 7"
    assert t0 <= proc.at <= time.time()
    assert proc.end(30) == -signal.SIGTERM
    quick = chip_smoke.OpsProc([sys.executable, "-c", "print('bye')"], None,
                               "quick")
    with pytest.raises(AssertionError, match="exited 0"):
        quick.wait_for("READY", 60)



# ---- phase "elastic" ------------------------------------------------------------

def test_elastic_phase_runs_last_and_is_documented():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main("):src.index("def thread_cpu_s(")]
    order = [main.index(f'phase("{p}")') for p in ("ops", "elastic")]
    assert order == sorted(order)
    assert main.index('phase("elastic")') > max(
        main.index(f'phase("{p}")') for p in ("slice", "trainer", "tune"))
    assert '["launches_by_path"]["elastic"]' in main
    assert " 17. elastic:" in chip_smoke.__doc__


def _drill(n_layers=12, vocab=50304):
    """Records of a 2 -> 1 -> 2 drill as elastic_loop writes them: world 2
    to step 14, the kill, world 1 from the checkpoint after step 9, world
    2 again from the checkpoint after step 19."""
    records, clock = [], iter(range(10 ** 6))
    first = float(np.log(vocab))

    def steps(world, start, stop):
        for s in range(start, stop):
            for rank in range(world):
                rec = {"rank": rank, "world": world, "time": next(clock),
                       "step": s, "loss": first - 2e-3 * s,
                       "step_ms": 50.0, "rows": 16 // world,
                       "peak_gib": 13.0,
                       "launches": {n: n_layers
                                    for n in chip_smoke.KERNEL_SOURCES}}
                if rank == 0:
                    rec["full_loss"] = first - 1e-3 * s
                    rec["eval_launches"] = {
                        n: n_layers if n == "flash_fwd" else 0
                        for n in chip_smoke.KERNEL_SOURCES}
                records.append(rec)

    def resume(world, at):
        for rank in range(world):
            records.append({"rank": rank, "world": world,
                            "time": next(clock), "resume": at, "load_s": 1.0,
                            "params_equal": True, "adam_equal": True,
                            "adam_steps": [at]})

    steps(2, 0, 15)
    resume(1, 10)
    steps(1, 10, 23)
    resume(2, 20)
    steps(2, 20, 26)
    return records


def test_elastic_checks_accept_a_drill():
    assert chip_smoke.check_elastic_records(_drill(), 12, 50304) == [2, 1, 2]


def _fault(name):
    records = _drill()
    steps = [r for r in records if "step" in r]
    resumes = [r for r in records if "resume" in r]
    if name == "no re-grow":
        return [r for r in records if r["time"] < resumes[-1]["time"]]
    if name == "a fresh start":
        for r in steps:
            if r["world"] == 1:
                r["step"] -= 10
        return records
    if name == "params off the checkpoint":
        resumes[0]["params_equal"] = False
    elif name == "AdamW's step off the resume step":
        resumes[-1]["adam_steps"] = [19]
    elif name == "a re-run loss 6% off":
        next(r for r in steps if r["world"] == 1)["full_loss"] += \
            0.06 * float(np.log(50304))
    elif name == "11 launches of dq":
        steps[-1]["launches"] = dict(steps[-1]["launches"], flash_bwd_dq=11)
    elif name == "no launch counted":
        steps[3]["launches"] = {}
    elif name == "a backward launch in the evaluation":
        steps[0]["eval_launches"] = dict(steps[0]["eval_launches"],
                                         flash_bwd_dq=1)
    elif name == "a first loss off ln(vocab)":
        steps[0]["full_loss"] += 0.6
    elif name == "a loss that does not fall":
        for r in steps:
            if "full_loss" in r:
                r["full_loss"] = float(np.log(50304))
    return records


@pytest.mark.parametrize("name", [
    "no re-grow", "a fresh start", "params off the checkpoint",
    "AdamW's step off the resume step", "a re-run loss 6% off",
    "11 launches of dq", "no launch counted",
    "a backward launch in the evaluation", "a first loss off ln(vocab)",
    "a loss that does not fall"])
def test_elastic_checks_reject(name):
    with pytest.raises(AssertionError):
        chip_smoke.check_elastic_records(_fault(name), 12, 50304)


# ---- phase "examples" -----------------------------------------------------------

def test_examples_phase_runs_last_and_is_documented():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main("):src.index("def thread_cpu_s(")]
    phases = [line.split('phase("')[1].split('"')[0]
              for line in main.splitlines() if 'with phase("' in line]
    assert phases[-2:] == ["elastic", "examples"], phases
    assert '["launches_by_path"]["examples"]' in main
    assert " 18. examples:" in chip_smoke.__doc__


def _example_history(cfg, steps=10):
    """Reports of the example's run as example_loop makes them."""
    fwd = cfg.n_layers * (2 if cfg.remat else 1)
    first = float(np.log(cfg.vocab_size))
    return [{"step": i, "loss": first - 0.05 * i, "time": 1.0 + 0.1 * i,
             "peak_gib": 12.0,
             "launches": {"flash_fwd": fwd * (i + 1),
                          "flash_bwd_dkv": cfg.n_layers * (i + 1),
                          "flash_bwd_dq": cfg.n_layers * (i + 1)}}
            for i in range(steps)]


@pytest.mark.parametrize("remat", [False, True])
def test_example_checks_accept_a_run(remat):
    cfg = chip_smoke.slice_config().replace(remat=remat)
    got = chip_smoke.check_example_records(_example_history(cfg), cfg, 10)
    assert got == {"flash_fwd": 12 * (2 if remat else 1) * 10,
                   "flash_bwd_dkv": 120, "flash_bwd_dq": 120}


@pytest.mark.parametrize("fault", [
    "a step missing", "a NaN loss", "a first loss off ln(vocab)",
    "a loss that does not fall", "11 launches of dq in a step",
    "no launch counted", "the forward once a layer under remat"])
def test_example_checks_reject(fault):
    cfg = chip_smoke.slice_config()
    history = _example_history(cfg)
    if fault == "a step missing":
        del history[4]
    elif fault == "a NaN loss":
        history[3]["loss"] = float("nan")
    elif fault == "a first loss off ln(vocab)":
        history[0]["loss"] += 0.6
    elif fault == "a loss that does not fall":
        history[-1]["loss"] = history[0]["loss"]
    elif fault == "11 launches of dq in a step":
        for m in history[5:]:
            m["launches"] = dict(m["launches"],
                                 flash_bwd_dq=m["launches"]["flash_bwd_dq"]
                                 - 1)
    elif fault == "no launch counted":
        for m in history:
            m["launches"] = {n: 0 for n in m["launches"]}
    elif fault == "the forward once a layer under remat":
        cfg = cfg.replace(remat=True)
    with pytest.raises(AssertionError):
        chip_smoke.check_example_records(history, cfg, 10)


def test_example_loop_adds_launches_time_and_memory(monkeypatch):
    """The wrapped loop's reports carry the launches since the loop began
    (zeroed first), and the report in place is the loop's again after."""
    from ray_tpu_torch import train
    got = []
    monkeypatch.setattr(train, "report",
                        lambda metrics, **kw: got.append(metrics))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 2**30)
    before = train.report
    pflash.launches["flash_fwd"] = 5

    def loop(config):
        import ray_tpu_torch.train as t
        for i in range(config["steps"]):
            pflash.launches["flash_fwd"] += 12
            t.report({"step": i})

    chip_smoke.example_loop(loop)({"steps": 2})
    assert train.report is before
    assert [m["step"] for m in got] == [0, 1]
    assert [m["launches"]["flash_fwd"] for m in got] == [12, 24]
    assert got[0]["peak_gib"] == 1.0 and got[1]["time"] >= got[0]["time"]
    pflash.reset_launches()
