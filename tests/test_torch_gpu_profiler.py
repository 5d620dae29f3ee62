"""Device profiling of the port (ray_tpu_torch/util/gpu_profiler.py and
_private/profiler.py:device_profile), on the CPU.

Mirrors of tests/test_tpu_profiler.py's three tests with device="cpu"
(torch.profiler traces CPU activities here; on the card it adds CUDA's),
the device rule (no device means the card, and raises without one), the
trace summary's arithmetic on a synthetic trace, and device_profile's
report: skipped where CUDA is not initialized, a trace directory and the
card names where it is; the live server (start_server, capture) and the
one session a process. The remote path (util.state.profile(device=True)
through a cluster) is in tests/test_torch_runtime.py, on its cluster.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import profiler
from ray_tpu_torch.util import gpu_profiler


def _trace_json(run):
    names = [n for n in os.listdir(run)
             if n.endswith(gpu_profiler.TRACE_SUFFIX)]
    assert len(names) == 1, names
    with open(os.path.join(run, names[0])) as f:
        return json.load(f)


def test_trace_produces_chrome_trace_capture(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    with gpu_profiler.trace(str(tmp_path), device="cpu") as d:
        with gpu_profiler.annotate("matmul-region"):
            (x @ x).sum()
        assert d == str(tmp_path)
    run = gpu_profiler.latest_trace_dir(str(tmp_path))
    assert run is not None
    events = _trace_json(run)["traceEvents"]
    assert any(e.get("name") == "matmul-region" for e in events)
    assert any(e.get("name") == "aten::mm" for e in events)


def test_profile_step_returns_result_and_dir(tmp_path):
    out, d = gpu_profiler.profile_step(
        lambda a, b: a + b, torch.ones(4), torch.ones(4),
        log_dir=str(tmp_path / "p"), device="cpu")
    np.testing.assert_allclose(out.numpy(), 2.0)
    assert d == str(tmp_path / "p")
    assert gpu_profiler.latest_trace_dir(d) is not None


def test_device_memory_profile_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gpu_profiler.device_memory_profile(str(tmp_path / "mem.pickle"))
    assert not (tmp_path / "mem.pickle").exists()


def test_trace_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with gpu_profiler.trace(str(tmp_path)):
            pass
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpu_profiler.profile_step(lambda: None, log_dir=str(tmp_path))


def test_start_server_captures_the_process_in_the_trace_layout(tmp_path):
    """jax.profiler.start_server's counterpart: capture() through the
    server's port takes a trace of the process (here a matmul loop on
    another thread: with no card in use, every thread's operators) and
    answers with its run directory, the one latest_trace_dir finds; once
    stopped the server takes no capture."""
    server = gpu_profiler.start_server(0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    stop = threading.Event()

    def work():
        while not stop.is_set():
            with gpu_profiler.annotate("server-region"):
                (x @ x).sum()
            stop.wait(0.005)

    worker = threading.Thread(target=work)
    worker.start()
    try:
        run = gpu_profiler.capture(server.port, 300, str(tmp_path))
    finally:
        stop.set()
        worker.join(timeout=30)
        server.stop()
    assert run == gpu_profiler.latest_trace_dir(str(tmp_path))
    assert os.path.dirname(run) == str(tmp_path / "plugins" / "profile")
    names = {e.get("name") for e in _trace_json(run)["traceEvents"]}
    assert {"server-region", "aten::mm"} <= names
    with pytest.raises(OSError):
        gpu_profiler.capture(server.port, 10, str(tmp_path / "after"))


@pytest.mark.parametrize("other", ["torch.profiler", "trace"])
def test_capture_while_another_session_runs_is_an_error(tmp_path, other):
    """One torch.profiler session a process (CUPTI takes one subscriber):
    a capture while another runs, started with torch.profiler directly or
    by trace(), is answered with an error and writes nothing."""
    from torch.profiler import ProfilerActivity, profile
    server = gpu_profiler.start_server(0)
    try:
        if other == "trace":
            session = gpu_profiler.trace(str(tmp_path / "own"), device="cpu")
        else:
            session = profile(activities=[ProfilerActivity.CPU])
        with session:
            with pytest.raises(RuntimeError, match="already running"):
                gpu_profiler.capture(server.port, 50, str(tmp_path / "c"))
        assert gpu_profiler.latest_trace_dir(str(tmp_path / "c")) is None
        run = gpu_profiler.capture(server.port, 50, str(tmp_path / "c"))
        assert run == gpu_profiler.latest_trace_dir(str(tmp_path / "c"))
    finally:
        server.stop()


def test_trace_refuses_a_second_session(tmp_path):
    with gpu_profiler.trace(str(tmp_path / "a"), device="cpu"):
        with pytest.raises(gpu_profiler.SessionBusy):
            with gpu_profiler.trace(str(tmp_path / "b"), device="cpu"):
                pass
    assert gpu_profiler.latest_trace_dir(str(tmp_path / "b")) is None
    assert gpu_profiler.latest_trace_dir(str(tmp_path / "a")) is not None


def test_summary_of_a_synthetic_trace(tmp_path):
    """Launch counts and summed durations by name, the busy union of the
    device's intervals, the window and its idle gaps (microseconds)."""
    run = tmp_path / "plugins" / "profile" / "r"
    run.mkdir(parents=True)
    events = [
        {"ph": "X", "cat": "kernel", "name": "flash_fwd", "ts": 0,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd", "ts": 5,
         "dur": 10},                                   # overlaps: busy 15
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 40,
         "dur": 5},                                    # gap 25
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 50, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 1000},                                 # host: ignored
    ]
    (run / ("host" + gpu_profiler.TRACE_SUFFIX)).write_text(
        json.dumps({"traceEvents": events}))
    s = gpu_profiler.summary(str(run))
    assert s["kernels"] == {
        "flash_fwd": {"cat": "kernel", "count": 2, "us": 20.0},
        "Memcpy DtoH": {"cat": "gpu_memcpy", "count": 1, "us": 5.0},
        "gemm": {"cat": "kernel", "count": 1, "us": 50.0}}
    assert s["busy_us"] == 70.0 and s["window_us"] == 100.0
    assert s["idle_gaps_us"] == [25.0, 5.0]
    table = gpu_profiler.summary_table(str(run))
    assert table.splitlines()[2].split()[-1] == "gemm"


def test_device_profile_skips_without_cuda_initialized(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    out = profiler.device_profile(duration_s=0.05)
    assert out["pid"] == os.getpid()
    assert "CUDA not initialized" in out["skipped"]
    assert "xplane_dir" not in out


def test_device_profile_reports_trace_and_cards(tmp_path, monkeypatch):
    """Where CUDA is initialized: a trace of the window (CPU activities
    here, the card's too on it) under `xplane_dir`, the cards by name."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: f"card {i}")
    cpu_trace = gpu_profiler.trace
    monkeypatch.setattr(gpu_profiler, "trace",
                        lambda d: cpu_trace(d, device="cpu"))
    out = profiler.device_profile(duration_s=0.05, log_dir=str(tmp_path))
    assert "error" not in out, out
    assert out["xplane_dir"] == str(tmp_path)
    assert out["devices"] == ["card 0", "card 1"]
    assert "traceEvents" in _trace_json(
        gpu_profiler.latest_trace_dir(out["xplane_dir"]))


def test_device_profile_reports_errors(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)

    def broken(d):
        raise OSError("no room")

    monkeypatch.setattr(gpu_profiler, "trace", broken)
    out = profiler.device_profile(duration_s=0.05)
    assert out["error"] == "OSError: no room"


def test_device_profile_one_trace_for_concurrent_calls(tmp_path,
                                                       monkeypatch):
    """The cluster fan-out can reach a process twice at once: one
    torch.profiler session runs (two CUPTI subscribers are refused), and
    both callers get its report."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    sessions = []
    cpu_trace = gpu_profiler.trace

    def counted(d):
        sessions.append(d)
        return cpu_trace(d, device="cpu")

    monkeypatch.setattr(gpu_profiler, "trace", counted)
    reports = [None, None]

    def call(i):
        reports[i] = profiler.device_profile(duration_s=0.5,
                                             log_dir=str(tmp_path / str(i)))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(sessions) == 1
    assert reports[0] == reports[1] and reports[0]["devices"] == ["card"]
    assert reports[0]["xplane_dir"] == sessions[0]
