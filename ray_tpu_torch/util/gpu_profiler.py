"""Device-side profiling: torch.profiler wrappers for CUDA traces.

The counterpart of ray_tpu/util/tpu_profiler.py. On the card the
interesting trace is the DEVICE one: kernel timelines, copies, the gaps
between them. This module exposes torch.profiler with the framework's
ergonomics:

    with ray_tpu_torch.util.gpu_profiler.trace("/tmp/prof"):
        train_step(...)

Each capture is a Chrome-trace JSON (chrome://tracing, Perfetto, or
TensorBoard's PyTorch profiler plugin) at
``<log_dir>/plugins/profile/<run>/<host>.pt.trace.json``; ``summary``
reads one back into device time by kernel and the device's idle gaps.
Entry points run on the card unless the caller names another device:
``device=None`` is CUDA, and raises where there is none; ``device="cpu"``
traces CPU activities only.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import socket
import tempfile
import time
from typing import Any, Dict, Iterator, Optional

TRACE_SUFFIX = ".pt.trace.json"
# Chrome-trace categories of the work the device runs
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# idle gaps summary() reports, longest first
IDLE_GAPS = 5


def _resolve(device):
    from ray_tpu_torch._device import resolve_device
    return resolve_device(device)


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[str]:
    """Capture a trace of the with-block into a new run directory under
    log_dir (CPU and CUDA activities; CPU only for device="cpu")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = _resolve(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    run = os.path.join(log_dir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S")
                       + f"_{time.time_ns() % 10**9:09d}_{os.getpid()}")
    os.makedirs(run, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if dev.type == "cuda":
            # intentional barrier: the window must hold the device work
            # the block queued, or the trace under-reports it
            torch.cuda.synchronize(dev)  # graftlint: disable=RT021
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(run, socket.gethostname() + TRACE_SUFFIX))


def start_server(port: int = 9012):
    """jax.profiler's live profiler server has no torch.profiler
    counterpart."""
    raise NotImplementedError(
        "torch.profiler has no live profiler server (ROADMAP.md, Queue 1 "
        "item 5, 'gpu_profiler.start_server'); take a trace of a remote "
        "process with ray_tpu_torch.util.state.profile(device=True)")


def annotate(name: str):
    """Named region inside a trace (torch.profiler.record_function)."""
    import torch
    return torch.profiler.record_function(name)


def latest_trace_dir(log_dir: str) -> Optional[str]:
    """The newest capture under log_dir, if any."""
    pattern = os.path.join(log_dir, "plugins", "profile", "*")
    runs = sorted(glob.glob(pattern), key=os.path.getmtime)
    return runs[-1] if runs else None


def device_memory_profile(path: Optional[str] = None) -> bytes:
    """The caching allocator's snapshot of device memory (segments,
    blocks, and the allocation history when recording), pickled as
    torch.cuda.memory._dump_snapshot writes it (pytorch.org/memory_viz
    reads it); written to `path` when given. Raises without CUDA."""
    import pickle

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device; "
                           "none is available")
    blob = pickle.dumps(torch.cuda.memory._snapshot())
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def profile_step(fn, *args, log_dir: Optional[str] = None, device=None,
                 **kwargs):
    """One-shot: run fn under a trace, return (result, log_dir). The
    trace stops after the card has finished the step's work."""
    log_dir = log_dir or os.path.join(
        tempfile.gettempdir(), f"ray_tpu_torch_prof_{int(time.time())}")
    with trace(log_dir, device=device):
        out = fn(*args, **kwargs)
    return out, log_dir


def _trace_file(run: str) -> str:
    files = sorted(glob.glob(os.path.join(run, "*" + TRACE_SUFFIX)))
    if not files:
        raise FileNotFoundError(f"no {TRACE_SUFFIX} file in {run}")
    return files[0]


def summary(run: str) -> Dict[str, Any]:
    """Device time of one capture directory: per kernel (and copy or
    memset) name its category, launches and summed microseconds, the
    device's busy microseconds (the union of its intervals), the window
    from the first start to the last end, and the IDLE_GAPS longest
    idle gaps in it."""
    with open(_trace_file(run)) as f:
        events = json.load(f)["traceEvents"]
    by_name: Dict[str, Dict[str, float]] = {}
    spans = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        row = by_name.setdefault(e["name"], {"cat": e["cat"], "count": 0,
                                             "us": 0.0})
        row["count"] += 1
        row["us"] += dur
        spans.append((t0, t0 + dur))
    spans.sort()
    busy, idle = 0.0, []
    end = None
    for t0, t1 in spans:
        if end is None or t0 > end:
            if end is not None:
                idle.append(t0 - end)
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    window = (end - spans[0][0]) if spans else 0.0
    return {"kernels": by_name, "busy_us": busy, "window_us": window,
            "idle_gaps_us": sorted(idle, reverse=True)[:IDLE_GAPS]}


def summary_table(run: str, rows: int = 40) -> str:
    """summary() as text: device time by name, largest first."""
    s = summary(run)
    total = sum(r["us"] for r in s["kernels"].values())
    lines = [f"device busy {s['busy_us'] / 1e3:.3f} ms of a "
             f"{s['window_us'] / 1e3:.3f} ms window; longest idle gaps "
             f"(us): {[round(g, 1) for g in s['idle_gaps_us']]}",
             f"{'ms':>10} {'%':>6} {'launches':>8}  name"]
    for name, r in sorted(s["kernels"].items(),
                          key=lambda kv: -kv[1]["us"])[:rows]:
        share = 100.0 * r["us"] / total if total else 0.0
        lines.append(f"{r['us'] / 1e3:10.3f} {share:6.2f} "
                     f"{r['count']:8d}  {name[:160]}")
    return "\n".join(lines)
