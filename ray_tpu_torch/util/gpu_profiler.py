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

``start_server(port)`` is the live server of jax.profiler.start_server:
a daemon thread answers ``capture(port, duration_ms, log_dir)`` (the
counterpart of jax.collect_profile) with a trace of the process for
that window (the card's kernels where it uses one, every thread's
operators where it does not), written in trace()'s layout. A process runs one
torch.profiler session at a time (CUPTI takes one subscriber): trace()
raises, and a capture is answered with an error, while another runs.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import socket
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterator, Optional

TRACE_SUFFIX = ".pt.trace.json"
# Chrome-trace categories of the work the device runs
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# idle gaps summary() reports, longest first
IDLE_GAPS = 5


def _resolve(device):
    from ray_tpu_torch._device import resolve_device
    return resolve_device(device)


# the process's one torch.profiler session, held by trace()
_session = threading.Lock()


class SessionBusy(RuntimeError):
    """Another torch.profiler session runs in this process."""


def _open_session() -> None:
    import torch.autograd.profiler as autograd_profiler
    if not _session.acquire(blocking=False):
        raise SessionBusy("a trace of this process is already running")
    # a session the caller started with torch.profiler directly
    if autograd_profiler._is_profiler_enabled:
        _session.release()
        raise SessionBusy("a torch.profiler session is already running in "
                          "this process")


def _all_threads_config():
    """torch.profiler's config recording every thread's ops, not only the
    starting thread's (the card's kernels are recorded whatever thread
    launched them); None where this torch lacks the option."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def trace(log_dir: str, device=None,
          all_threads: bool = False) -> Iterator[str]:
    """Capture a trace of the with-block into a new run directory under
    log_dir (CPU and CUDA activities; CPU only for device="cpu"; the
    operators of this thread, of every thread with `all_threads`);
    raises SessionBusy, before the block runs, while another
    torch.profiler session runs in the process."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = _resolve(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _open_session()
    try:
        path = os.path.join(log_dir, "plugins", "profile",
                            time.strftime("%Y_%m_%d_%H_%M_%S")
                            + f"_{time.time_ns() % 10**9:09d}_{os.getpid()}")
        config = _all_threads_config() if all_threads else None
        prof = profile(activities=activities,
                       **({"experimental_config": config} if config else {}))
        prof.start()
        try:
            yield log_dir
        finally:
            if dev.type == "cuda":
                # intentional barrier: the window must hold the device work
                # the block queued, or the trace under-reports it
                torch.cuda.synchronize(dev)  # graftlint: disable=RT021
            prof.stop()
            os.makedirs(path, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(path, socket.gethostname() + TRACE_SUFFIX))
    finally:
        _session.release()


class ProfilerServer:
    """The live profiler server start_server returns: a daemon thread
    answering captures on `port` until stop()."""

    def __init__(self, port: int, host: str):
        self._http = ThreadingHTTPServer((host, port), _CaptureHandler)
        self._http.daemon_threads = True
        self.port = self._http.server_address[1]
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        name="gpu-profiler-server",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self._thread.join(timeout=10)


def _capture_here(duration_ms: float, log_dir: str) -> str:
    """A trace of this process for `duration_ms`, CUDA activity where the
    process uses a card (the card's kernels, whatever thread launched
    them), every thread's operators where it does not; the run directory
    (the newest under log_dir: the process runs one session at a time).
    Where the process uses a card its CPU side stays this thread's:
    after a session recording every thread (torch 2.11), a later trace
    in the process lost some of the card's events."""
    import torch
    device = "cuda" if torch.cuda.is_initialized() else "cpu"
    with trace(log_dir, device=device, all_threads=device == "cpu"):
        time.sleep(duration_ms / 1e3)
    return latest_trace_dir(log_dir)


class _CaptureHandler(BaseHTTPRequestHandler):
    """GET /capture?duration_ms=D&log_dir=DIR -> {"trace": run dir}, or
    409 {"error": ...} while another session runs (nothing written)."""

    def do_GET(self):  # noqa: N802 - http.server's name
        from urllib.parse import parse_qs, urlparse
        url = urlparse(self.path)
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        if url.path != "/capture" or "log_dir" not in query:
            return self._reply(404, {"error": f"no such request: {self.path}"})
        try:
            run = _capture_here(float(query.get("duration_ms", 1000)),
                                query["log_dir"])
        except SessionBusy as e:
            return self._reply(409, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - answered, not raised
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        self._reply(200, {"trace": run})

    def _reply(self, status: int, body: Dict[str, Any]) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # no line on stderr a request
        pass


def start_server(port: int = 9012, host: str = "127.0.0.1") -> ProfilerServer:
    """Start the live profiler server on `port` (0: one the OS picks, in
    the returned server's .port), jax.profiler.start_server's
    counterpart; capture() takes a trace of this process through it, and
    the returned server's stop() ends it."""
    return ProfilerServer(port, host)


def capture(port: int, duration_ms: float, log_dir: str,
            host: str = "127.0.0.1") -> str:
    """A trace of the process serving `port` (start_server) for
    `duration_ms`, written under `log_dir` in trace()'s layout (as
    jax.collect_profile asks JAX's server); returns its run directory,
    which summary() reads. Raises RuntimeError with the server's answer
    while another torch.profiler session runs there."""
    from urllib.error import HTTPError
    from urllib.parse import urlencode
    from urllib.request import urlopen
    query = urlencode({"duration_ms": duration_ms,
                       "log_dir": os.path.abspath(log_dir)})
    try:
        with urlopen(f"http://{host}:{port}/capture?{query}",
                     timeout=duration_ms / 1e3 + 120) as reply:
            return json.loads(reply.read())["trace"]
    except HTTPError as e:
        raise RuntimeError(f"capture refused ({e.code}): "
                           f"{json.loads(e.read()).get('error')}") from None


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
