#!/usr/bin/env python3
"""Same-call comparison of two builds of flash-attention kernels on one H100.

    python3 chip_kernel_ab.py --old DIR [--kernels NAME ...] [--out FILE]

--kernels chooses among flash_fwd, flash_bwd_dkv and flash_bwd_dq (by
default the first two). DIR holds another version's sources of those
kernels (``<name>.cu``) and the headers they include (for example the
sources of an earlier commit, from ``git archive``). Both versions are
built with the same nvcc flags; each is checked against the plain
versions at the GPT-2-125M shape on the same inputs (chip_smoke.py's
element-by-element check of the chosen kernels); then the two are timed
in turns (old, new, new, old, 50 warm launches each by CUDA events) on the
same inputs. Prints and writes one JSON object: per kernel and version the
registers, shared memory and spills nvcc reports, the SASS counts, the
times, and beside them the bound, the plain version's time and the
library call's time, with the card's name and power limit. Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke

KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
DEFAULT_KERNELS = ("flash_fwd", "flash_bwd_dkv")
SHAPE = (16, 1024, 6, 128)   # GPT-2-125M: batch 16, T 1024, 6 heads of 128
ITERS = 50


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the other version's sources")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(DEFAULT_KERNELS),
                    help="the kernels to compare (default: %(default)s)")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    kernels = tuple(k for k in KERNELS if k in args.kernels)

    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch._device import gpu_info, peak_rates
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    kind, smi = torch.cuda.get_device_name(0), gpu_info()
    peak_flops, peak_bw = peak_rates(kind)
    outs = {"new": _build.build(),
            "old": _build.build(csrc=args.old.resolve(),
                                root=args.old.resolve() / "_build",
                                sources=tuple(k + ".cu" for k in kernels))}
    fns = {v: {k: _build.load(k, out) for k in kernels}
           for v, out in outs.items()}
    result = {"device": kind, "nvidia_smi": smi, "shape": list(SHAPE),
              "causal": True, "kernels": {}}
    for version, out in outs.items():
        logs = _build.build_logs(out)
        for k in kernels:
            used, spilled, sass = chip_smoke.build_report(
                _build, logs[k + ".cu"], k + ".cu", out)
            result["kernels"].setdefault(k, {})[version] = {
                "ptxas": used, "spilled_bytes": spilled, "sass": sass}

    def use(version):
        fa._build._loaded.update(fns[version])

    b, t, h, d = SHAPE
    for version in ("old", "new"):
        use(version)
        print(f"[{version}]", flush=True)
        # the same inputs for both versions
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        errs, tensors = chip_smoke.check_kernels(torch, fa, b, t, h, d, gen,
                                                 qk_views=False, names=kernels)
        for k in kernels:
            result["kernels"][k][version]["max_abs_err"] = errs[k]
    q, k_, v, do, o, lse, di = tensors
    scale = d ** -0.5
    runs = {"flash_fwd": lambda: fa._flash_fwd_cuda(q, k_, v, scale, True),
            "flash_bwd_dkv": lambda: fa._flash_bwd_dkv_cuda(
                q, k_, v, do, lse, di, scale, True),
            "flash_bwd_dq": lambda: fa._flash_bwd_dq_cuda(
                q, k_, v, do, lse, di, scale, True)}
    times = {k: {"old": [], "new": []} for k in kernels}
    for version in ("old", "new", "new", "old"):
        use(version)
        for k in kernels:
            times[k][version].append(chip_smoke.cuda_ms(torch, runs[k], ITERS))
    plain = {"flash_fwd": lambda: fa.flash_fwd_ref(q, k_, v, scale, True),
             "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_ref(
                 q, k_, v, do, lse, di, scale, True),
             "flash_bwd_dq": lambda: fa.flash_bwd_dq_ref(
                 q, k_, v, do, lse, di, scale, True)}
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k_, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backward = chip_smoke.library_backward(torch, qt, kt, vt, dot, scale)
    library = {"flash_fwd": lambda: sdpa(qt, kt, vt, is_causal=True),
               "flash_bwd_dkv": backward, "flash_bwd_dq": backward}
    for k in kernels:
        bound, bound_by = chip_smoke.bounds_ms(k, b, t, h, d, peak_flops,
                                               peak_bw)
        for version in ("old", "new"):
            result["kernels"][k][version]["ms"] = times[k][version]
        result["kernels"][k].update({
            "bound_ms": bound, "bound_by": bound_by,
            "plain_ms": chip_smoke.cuda_ms(torch, plain[k], 3),
            "library_ms": chip_smoke.cuda_ms(torch, library[k], ITERS),
            "library_call": ("scaled_dot_product_attention, causal"
                             if k == "flash_fwd" else chip_smoke.BWD_LIBRARY)})
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
