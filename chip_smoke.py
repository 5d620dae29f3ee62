#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch on one NVIDIA H100 (sm_90).

    python3 chip_smoke.py                    # from the repo root
    python3 chip_smoke.py --profile FILE     # also profiles one step and
                                             # writes the table to FILE

Phases, each of which raises (and so exits non-zero) on failure:
  1. device: CUDA present, capability (9, 0); prints the card's name and
     power limit; TF32 off so the f32 plain versions are full f32.
  2. build: compiles the flash-attention kernels from ops/csrc with nvcc;
     prints each library's registers, spills and SASS counts (cuobjdump)
     and fails if a kernel holds no HGMMA (wgmma) or UTMALDG (TMA load),
     holds HMMA (mma.sync), or spills.
  3. kernels: each kernel against its plain PyTorch version on the same
     bf16 inputs, at the GPT-2-125M shape [16, 1024, 6, 128] causal, a
     ragged T, a head_dim-64 case, a non-causal case and a T shorter than
     one tile, and dQ again at the main shape from DQ_SEEDS; then times
     kernel, plain version and, where one PyTorch call computes the same
     function, that call (for the backward pair, PyTorch's
     flash-attention backward, which gives dQ, dK and dV).
  4. reference: a narrow model's loss and grads on the card (bf16, through
     the kernels) against the port's CPU path (f32, plain versions) from
     the same params.
  5. the slice: GPT-2-125M training steps at batch 16 x 1024 through
     make_train_step, exactly as bench.py runs the JAX package (3 warm-up
     steps, then timed steps on the same batch); the launch counters,
     zeroed just before, must show 12 launches of each kernel per step.
Then it prints {"kernels": [...]}, the nvidia-smi line, and
{"ok": true, "device": {...}} last. Without CUDA it exits non-zero first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import sys
import time

# Each element of a kernel's output is held to its plain version by
# |kernel - plain| <= RTOL |plain| + ATOL_ROW rms(row of plain), a row
# being the last dimension: a query row of o and dq, a key row of dk and
# dv. The kernels round P and dS to bf16 (unit roundoff 2^-8) before
# their products, as the Pallas kernel does (flash_attention.py:471), and
# their outputs are bf16; the plain version stays in f32. Rounding P adds
# to each output element an error of random sign with a std of about
# 2.3e-3 of its row's RMS, about 1.2e-2 at the largest of the ~12.6M
# elements at the main shape; ATOL_ROW leaves room for that, and RTOL
# (four unit roundoffs) for the bf16 output.
#
# A row of dq that is zero in exact arithmetic has no RMS to scale from.
# Query 0 under the causal mask sees key 0 alone, so P = 1 and
# dP - di = dO_0 . V_0 - O_0 . dO_0 = 0 (O_0 = V_0): what kernel and plain
# version give there is the f32 rounding of those two dot products. Each
# is a sum of D products, rounded by at most gamma_D sum_d |terms| in any
# order of summation (gamma_D = D u / (1 - D u), u = 2^-24: Higham,
# Accuracy and Stability of Numerical Algorithms, 3.1). dS = P (dP - di)
# carries that times P, and dQ = scale dS K carries it through K: in the
# kernel and in the plain version alike, element d of row i of dq lies
# within E_id of its exact value, and the two within 2 E_id of each
# other, where
#   E_id = scale gamma_D sum_j P_ij A_ij |K_jd|,
#   A_ij = sum_e |dO_ie V_je| + sum_e |O_ie dO_ie|.
# A row of dq is held to
# max(rms(row), 2 max_d E_id / ATOL_ROW) in place of rms(row)
# (dq_row_floor): a zero row may differ by its rounding bound, and a row
# whose RMS is above that floor is held exactly as before (the rows
# below it are query row 0 and the rare row whose P sits almost wholly on
# one key, where dP - di nearly cancels as well). o, dk and dv have no
# row that is zero in exact arithmetic; their rows' RMS is floored at
# 1e-3 of the tensor's (under the causal mask the last key rows of dk and
# dv, made of a few small P, can lie below that).
RTOL = 1.6e-2
ATOL_ROW = 3e-2
U_F32 = 2.0 ** -24   # unit roundoff of f32
LSE_TOL = 1e-3       # absolute, on lse (f32 throughout)
WARMUP, TIMED = 3, 10   # training steps, as bench.py warms up and times
BATCH = 16
SEED = 0
# the kernels' sources, each built for Hopper (TMA, wgmma), which the
# build phase checks in their SASS
HOPPER_SOURCES = ("flash_fwd.cu", "flash_bwd_dkv.cu", "flash_bwd_dq.cu")
# seeds of the extra dQ checks at the main shape
DQ_SEEDS = tuple(range(1, 9))
# each kernel's source and the TPU kernel it replaces
KERNEL_SOURCES = {
    "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:758"),
    "flash_bwd_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "jax/experimental/pallas/ops/tpu/flash_attention.py:1456")}
BWD_LIBRARY = "aten._scaled_dot_product_flash_attention_backward (dQ, dK, dV)"


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"[{name}] ...", flush=True)
    yield
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def cuda_ms(torch, fn, iters):
    """Mean time of fn on the card over `iters` warm launches (CUDA
    events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def excess(a, ref, floor=None):
    """Worst |a - ref| / (RTOL |ref| + ATOL_ROW max(rms_row(ref), floor))
    over all elements, `floor` being a tensor of one least RMS per row
    (last dimension 1) or, by default, 1e-3 of the tensor's RMS: at most 1
    passes, NaN fails."""
    a, ref = a.float(), ref.float()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    if floor is None:
        rms = rms.clamp_min(1e-3 * ref.pow(2).mean().sqrt().item())
    else:
        rms = rms.maximum(floor)
    return ((a - ref).abs() / (RTOL * ref.abs() + ATOL_ROW * rms)).max().item()


def dq_row_floor(torch, fa, q, k, v, do, o, lse, scale, causal):
    """2 max_d E_id / ATOL_ROW per row of dq (see the note at RTOL): the
    f32 rounding bound of dP - di carried through scale K, for kernel and
    plain version both. q, k, v, do, o f32 [B, T, H, D], lse f32
    [B, H, T]; returns [B, T, H, 1]."""
    d = q.shape[-1]
    gamma = d * U_F32 / (1 - d * U_F32)
    p = fa._probs(q, k, lse, scale, causal)                    # [B,H,T,T]
    dp_abs = torch.einsum("bqhd,bkhd->bhqk", do.abs(), v.abs())
    di_abs = (o.abs() * do.abs()).sum(-1).transpose(1, 2)      # [B,H,T]
    bound = torch.einsum("bhqk,bkhd->bqhd", p * (dp_abs + di_abs[..., None]),
                         k.abs())
    return bound.amax(-1, keepdim=True) * (2 * scale * gamma / ATOL_ROW)


def check_kernels(torch, fa, b, t, h, d, gen, qk_views=True, causal=True,
                  names=("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")):
    """Run the kernels `names` (by default all three) and their plain
    versions on the same bf16 inputs (causal or not); returns the max
    absolute error per kernel, and raises where an output is not within
    RTOL / ATOL_ROW of its plain version (excess above 1) or lse (checked
    with the forward) is not within LSE_TOL.

    q, k and v are views of one [B, T, 3, H, D] tensor, as the model's
    fused qkv projection gives them (models/transformer.py); with
    qk_views=False q and k are contiguous copies, as RoPE writes them, so
    every operand has the strides the main path gives the kernels."""
    qkv = torch.randn(b, t, 3, h, d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    if not qk_views:
        q, k = q.contiguous(), k.contiguous()
    do = torch.randn(b, t, h, d, device="cuda",
                     generator=gen).to(torch.bfloat16)
    scale = d ** -0.5
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    # the plain versions run in f32 on the same values, and their outputs
    # stay f32; the backward kernels get the plain lse/di, so each kernel
    # is checked alone
    f32 = [x.float() for x in (q, k, v, do)]
    o_ref, lse_ref = fa.flash_fwd_ref(*f32[:3], scale, causal)
    di = fa.row_dot(o_ref, do)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, di, scale, causal)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse_ref, di, scale, causal)
    torch.cuda.synchronize()
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*f32, lse_ref, di, scale, causal)
    dq_ref = fa.flash_bwd_dq_ref(*f32, lse_ref, di, scale, causal)
    dq_floor = dq_row_floor(torch, fa, *f32, o_ref, lse_ref, scale, causal)
    del f32
    # (output, plain output, row floor or None for the default)
    outs = {"flash_fwd": {"o": (o, o_ref, None)},
            "flash_bwd_dkv": {"dk": (dk, dk_ref, None),
                              "dv": (dv, dv_ref, None)},
            "flash_bwd_dq": {"dq": (dq, dq_ref, dq_floor)}}
    outs = {n: outs[n] for n in names}
    lse_err = ((lse - lse_ref).abs().max().item() if "flash_fwd" in names
               else 0.0)
    abs_errs, worst, line = {}, {}, []
    for name, pairs in outs.items():
        for out, (a, r, floor) in pairs.items():
            if not torch.isfinite(a.float()).all().item():
                raise AssertionError(f"non-finite {out} at {(b, t, h, d)}")
            err = (a.float() - r).abs().max().item()
            abs_errs[name] = max(abs_errs.get(name, 0.0), err)
            worst[out] = excess(a, r, floor)
            line.append(f"{out} max|err| {err:.3e} (max|plain| "
                        f"{r.abs().max().item():.3e}), excess "
                        f"{worst[out]:.3f}")
            if floor is not None:   # query row 0 alone
                row0 = excess(a[:, :1], r[:, :1], floor[:, :1])
                line[-1] += f" (row 0: {row0:.3f})"
    layout = "views" if qk_views else "contiguous"
    mode = "causal" if causal else "non-causal"
    print(f"  [{b},{t},{h},{d}] {mode}, q/k {layout}: " + "; ".join(line)
          + f"; lse max|err| {lse_err:.3e}", flush=True)
    for out, x in worst.items():
        if not x <= 1.0:
            raise AssertionError(f"{out} disagrees with its plain version "
                                 f"at {(b, t, h, d)} {mode}: excess {x:.3f}")
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_fwd lse error {lse_err:.3e}")
    return abs_errs, (q, k, v, do, o, lse, di)


def bounds_ms(name, b, t, h, d, peak_flops, peak_bw):
    """Least time on the card: the larger of FLOPs over the bf16 peak and
    bytes (each input read once, each output written once) over the
    memory rate. Causal: only the lower triangle's t(t+1)/2 pairs."""
    pairs = b * h * t * (t + 1) / 2
    tensor = b * t * h * d * 2           # one bf16 [B,T,H,D]
    stat = b * h * t * 4                 # one f32 [B,H,T]
    passes, nbytes = {
        "flash_fwd": (2, 3 * tensor + tensor + stat),
        "flash_bwd_dkv": (4, 4 * tensor + 2 * stat + 2 * tensor),
        "flash_bwd_dq": (3, 4 * tensor + 2 * stat + tensor),
    }[name]
    flops = passes * 2 * pairs * d
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def library_backward(torch, qt, kt, vt, dot, scale):
    """A closure running PyTorch's flash-attention backward on [B, H, T, D]
    views, its saved tensors taken from PyTorch's own forward on the same
    q, k, v (a yardstick only)."""
    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True,
                                                 False, scale=scale)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, True, seed, offset,
        scale=scale)


def build_report(build, log, src, out=None):
    """(one "D=<d>: registers, spills" entry per kernel instantiation,
    spilled bytes, SASS counts) of one library's nvcc -Xptxas -v log, the
    library being `src`'s in build directory `out` (by default the
    current build)."""
    used, spilled, name = [], 0, "?"
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?ILi(\d+)E", line)
        if m:
            name = f"D={m.group(1)}"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spilled += int(m.group(1)) + int(m.group(2))
            used.append(f"{name}: {m.group(0)}")
        m = re.search(r"Used (\d+) registers", line)
        if m and used:
            used[-1] += f", {m.group(1)} registers"
        if "Potential Performance Loss" in line:   # e.g. serialised wgmma
            used.append(f"{name}: {line.split('Loss: ')[-1].strip()}")
    return used, spilled, build.sass(src, out)


def grads_close(torch, model_gpu, model_cpu, tol):
    worst = 0.0
    for (name, pg), (_, pc) in zip(model_gpu.named_parameters(),
                                   model_cpu.named_parameters()):
        diff = (pg.grad.float().cpu() - pc.grad).norm() / pc.grad.norm()
        worst = max(worst, diff.item())
        if not diff.item() < tol:
            raise AssertionError(f"grad {name}: relative error {diff:.3e}")
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="profile one training step after the timed ones "
                         "and write the per-op table to FILE")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch._device import gpu_info, peak_rates
    from ray_tpu_torch.models import GPT2_125M, Transformer
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step

    with phase("device"):
        cap = torch.cuda.get_device_capability(0)
        if cap != (9, 0):
            raise AssertionError(f"needs an sm_90 card, got capability {cap}")
        kind = torch.cuda.get_device_name(0)
        smi = gpu_info()
        peak_flops, peak_bw = peak_rates(kind)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}; peaks {peak_flops / 1e12:.0f} "
              f"TFLOP/s bf16, {peak_bw / 1e12:.2f} TB/s", flush=True)

    with phase("build"):
        t0 = time.perf_counter()
        _build.build()
        for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            _build.kernel(name)
        print(f"  build {time.perf_counter() - t0:.1f} s", flush=True)
        sass, spills = {}, {}
        for src, log in _build.build_logs().items():
            used, spills[src], sass[src] = build_report(_build, log, src)
            print(f"  {src}: " + "; ".join(used) + f"; SASS {sass[src]}",
                  flush=True)
            if src in HOPPER_SOURCES and not (
                    sass[src]["HGMMA"] and sass[src]["UTMALDG"]
                    and not sass[src]["HMMA"]):
                raise AssertionError(f"{src} must use wgmma and TMA, and no "
                                     f"mma.sync: SASS {sass[src]}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = {}
    with phase("kernels"):
        check_kernels(torch, fa, 2, 1000, 3, 128, gen)   # ragged T
        check_kernels(torch, fa, 4, 520, 8, 64, gen)     # D = 64, ragged
        b, t, h, d = BATCH, GPT2_125M.max_seq_len, GPT2_125M.n_heads, \
            GPT2_125M.head_dim
        errs, (q, k, v, do, o, lse, di) = check_kernels(
            torch, fa, b, t, h, d, gen, qk_views=False)
        # the causal flag off (ragged T), and T inside one 128-row tile
        check_kernels(torch, fa, 2, 1000, 3, 128, gen, causal=False)
        check_kernels(torch, fa, 2, 100, 3, 128, gen)
        # dQ at the main shape from more seeds: its query row 0 is zero in
        # exact arithmetic and held to its rounding bound
        for seed in DQ_SEEDS:
            print(f"  seed {seed}:", end="")
            check_kernels(torch, fa, b, t, h, d,
                          torch.Generator(device="cuda").manual_seed(seed),
                          qk_views=False, names=("flash_bwd_dq",))
        scale = d ** -0.5
        runs = {
            "flash_fwd": (lambda: fa._flash_fwd_cuda(q, k, v, scale, True),
                          lambda: fa.flash_fwd_ref(q, k, v, scale, True)),
            "flash_bwd_dkv": (
                lambda: fa._flash_bwd_dkv_cuda(q, k, v, do, lse, di, scale,
                                               True),
                lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, di, scale,
                                             True)),
            "flash_bwd_dq": (
                lambda: fa._flash_bwd_dq_cuda(q, k, v, do, lse, di, scale,
                                              True),
                lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, di, scale,
                                            True)),
        }
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        dot = do.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # yardsticks only, never on the port's path: the forward, and
        # PyTorch's flash-attention backward, which gives dQ, dK and dV in
        # one call (both backward rows carry its time)
        bwd_call = library_backward(torch, qt, kt, vt, dot, scale)
        library = {
            "flash_fwd": ("scaled_dot_product_attention, causal",
                          lambda: sdpa(qt, kt, vt, is_causal=True)),
            "flash_bwd_dkv": (BWD_LIBRARY, bwd_call),
            "flash_bwd_dq": (BWD_LIBRARY, bwd_call)}
        lib_ms = {}
        for name, (kern, plain) in runs.items():
            bound, bound_by = bounds_ms(name, b, t, h, d, peak_flops,
                                        peak_bw)
            call, fn = library[name]
            if call not in lib_ms:
                lib_ms[call] = cuda_ms(torch, fn, 50)
            records[name] = {
                "max_abs_err": errs[name],
                "ms": cuda_ms(torch, kern, 50),
                "plain_ms": cuda_ms(torch, plain, 3),
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms[call], "library_call": call,
                "sass": sass[KERNEL_SOURCES[name][0].rsplit("/", 1)[1]],
            }
            print(f"  {name}: {json.dumps(records[name])}", flush=True)
        row_dot_ms = cuda_ms(torch, lambda: fa.row_dot(o, do), 50)
        print(f"  backward: dK/dV + dQ + row_dot "
              f"{records['flash_bwd_dkv']['ms']:.4f} + "
              f"{records['flash_bwd_dq']['ms']:.4f} + {row_dot_ms:.4f} = "
              f"{records['flash_bwd_dkv']['ms'] + records['flash_bwd_dq']['ms'] + row_dot_ms:.4f}"
              f" ms; {BWD_LIBRARY} {lib_ms[BWD_LIBRARY]:.4f} ms", flush=True)
        # yardstick only: PyTorch's fused attention forward + backward
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg),
                                dot)

        print(f"  sdpa fwd+bwd {cuda_ms(torch, sdpa_fwd_bwd, 20):.4f} ms; "
              "kernels fwd+dkv+dq "
              f"{sum(r['ms'] for r in records.values()):.4f} ms", flush=True)
        # fn (the library backward) holds views of q, k, v, do and its own
        # forward's output: free them before the slice's peak memory
        del q, k, v, do, o, lse, di, qt, kt, vt, qg, kg, vg, dot, bwd_call, \
            library, fn

    with phase("reference"):
        # a narrow model that takes the same kernels (head_dim 128, ragged
        # T): bf16 on the card against f32 plain versions on the CPU
        small = GPT2_125M.replace(d_model=256, n_heads=2, d_ff=512,
                                  n_layers=2, vocab_size=512, loss_chunk=0,
                                  attention_impl="auto")
        m_gpu = Transformer(small, seed=SEED)
        m_cpu = Transformer(small.replace(dtype="float32"), device="cpu")
        m_cpu.load_state_dict({n: p.cpu() for n, p in
                               m_gpu.state_dict().items()})
        tok = torch.randint(0, small.vocab_size, (2, 301), generator=gen,
                            device="cuda")
        l_gpu = m_gpu.loss({"tokens": tok})
        l_gpu.backward()
        l_cpu = m_cpu.loss({"tokens": tok.cpu()})
        l_cpu.backward()
        loss_err = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
        # bf16 compute against f32: 2e-2 on the loss, 5e-2 on each grad's
        # relative norm error
        if not (math.isfinite(l_gpu.item()) and loss_err < 2e-2):
            raise AssertionError(f"loss {l_gpu.item()} vs {l_cpu.item()}")
        worst = grads_close(torch, m_gpu, m_cpu, 5e-2)
        print(f"  loss bf16 card {l_gpu.item():.5f} vs f32 CPU "
              f"{l_cpu.item():.5f} (rel {loss_err:.2e}); worst grad rel "
              f"norm err {worst:.2e}", flush=True)
        del m_gpu, m_cpu

    with phase("slice"):
        cfg = GPT2_125M.replace(remat=False, attention_impl="auto",
                                loss_chunk=0)
        model = Transformer(cfg, seed=SEED)
        tokens = torch.randint(0, cfg.vocab_size,
                               (BATCH, cfg.max_seq_len + 1), generator=gen,
                               device="cuda")
        batch = {"tokens": tokens}
        init_state, train_step = make_train_step(
            lambda p, bt: model.loss(bt),
            optimizer=adamw(1e-4, weight_decay=0.01))
        state = init_state(dict(model.named_parameters()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses = []
        for _ in range(WARMUP):
            state, metrics = train_step(state, batch)
            losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = []
        for _ in range(TIMED):
            state, metrics = train_step(state, batch)
            timed.append(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(fa.launches)
        losses += [x.item() for x in timed]
        n_steps = len(losses)
        step_ms = dt / TIMED * 1e3
        tok_s = BATCH * cfg.max_seq_len * TIMED / dt
        print(f"  losses {['%.4f' % x for x in losses]}", flush=True)
        print(f"  grad_norm {metrics['grad_norm'].item():.4f}, step "
              f"{state['step']}", flush=True)
        print(f"  step {step_ms:.2f} ms, {tok_s:.1f} tokens/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches {launches}; {kind}; {smi}", flush=True)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite loss: {losses}")
        if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
            raise AssertionError(f"initial loss {losses[0]} is not near "
                                 f"ln({cfg.vocab_size})")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss does not fall: {losses}")
        want = cfg.n_layers * n_steps
        if launches != {n: want for n in launches}:
            raise AssertionError(f"expected {cfg.n_layers} launches of each "
                                 f"kernel per step ({want}), got {launches}")
        for name in records:
            records[name]["launches"] = launches[name]
        if args.profile:
            profile_step(torch, train_step, state, batch, args.profile)

    # after the runs, so that a spill does not hide what the kernels do
    spilled = {src: n for src, n in spills.items()
               if src in HOPPER_SOURCES and n}
    if spilled:
        raise AssertionError(f"spilled bytes (registers to local memory): "
                             f"{spilled}")
    kernels = [{"name": n, "route": "cuda", "source": KERNEL_SOURCES[n][0],
                "replaces": KERNEL_SOURCES[n][1], **records[n]}
               for n in records]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def profile_step(torch, train_step, state, batch, path):
    """One step under torch.profiler; writes the device time per op and
    kernel name to `path` and prints the top rows."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(state, batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=150)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    print("\n".join(table.splitlines()[:25]), flush=True)


if __name__ == "__main__":
    sys.exit(main())
