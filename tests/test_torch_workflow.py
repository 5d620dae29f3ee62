"""The port's durable workflows (workflow/__init__.py, a copy of the JAX
package's under the rename rule) on the CPU: per-step retries,
continuations, resume after a killed driver, events, and resume that
skips checkpointed steps.

Mirrors of tests/test_workflow_round4.py's seven cases and of
tests/test_misc_parity.py's test_workflow_resume_skips_completed_steps
on ray_tpu_torch, each with its storage under tmp_path. One cluster for
the module (ray_tpu_torch.init(num_cpus=4)); the kill-and-resume case
starts a driver of its own in a subprocess.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_step_retries_flaky_step(tmp_path):
    marker = str(tmp_path / "attempts")

    def flaky(x, marker=marker):
        with open(marker, "a") as f:
            f.write("x")
        with open(marker) as f:
            attempts = len(f.read())
        if attempts < 3:
            raise RuntimeError(f"flaky failure #{attempts}")
        return x * 2

    def finish(y):
        return y + 1

    flaky_r = ray_tpu_torch.remote(flaky)
    finish_r = ray_tpu_torch.remote(finish)
    node = finish_r.bind(workflow.options(flaky_r.bind(21), max_retries=3))
    out = workflow.run(node, workflow_id="wf_retry",
                       storage=str(tmp_path / "wf"))
    assert out == 43
    with open(marker) as f:
        assert len(f.read()) == 3  # two failures + one success


def test_step_without_retries_fails(tmp_path):
    def boom():
        raise ValueError("no retries here")

    node = ray_tpu_torch.remote(boom).bind()
    with pytest.raises(Exception):
        workflow.run(node, workflow_id="wf_noretry",
                     storage=str(tmp_path / "wf"))


def test_continuation_chains(tmp_path):
    def fib_step(a, b, n):
        if n <= 0:
            return b
        nxt = ray_tpu_torch.remote(fib_step).bind(b, a + b, n - 1)
        return workflow.continuation(nxt)

    node = ray_tpu_torch.remote(fib_step).bind(0, 1, 8)
    out = workflow.run(node, workflow_id="wf_cont",
                       storage=str(tmp_path / "wf"))
    a, b = 0, 1
    for _ in range(8):
        a, b = b, a + b
    assert out == b


def test_continuation_result_is_durable(tmp_path):
    calls = str(tmp_path / "calls")

    def outer(calls=calls):
        with open(calls, "a") as f:
            f.write("o")
        return workflow.continuation(ray_tpu_torch.remote(inner_fn).bind())

    def inner_fn(calls=calls):
        with open(calls, "a") as f:
            f.write("i")
        return "done"

    node = ray_tpu_torch.remote(outer).bind()
    st = str(tmp_path / "wf")
    assert workflow.run(node, workflow_id="wf_dur", storage=st) == "done"
    # resume: nothing runs again, outer's checkpoint holds the
    # continuation's final value
    assert workflow.resume(ray_tpu_torch.remote(outer).bind(),
                           workflow_id="wf_dur", storage=st) == "done"
    with open(calls) as f:
        assert f.read() == "oi"


def test_kill_driver_and_resume(tmp_path):
    """A driver of its own starts a 2-step chain whose second step
    stalls and is killed mid-run; resuming here restores the finished
    prefix and completes the chain."""
    storage = str(tmp_path / "wf")
    gate = str(tmp_path / "gate")
    script = f"""
import sys, time
sys.path.insert(0, {REPO!r})
import ray_tpu_torch
from ray_tpu_torch import workflow
ray_tpu_torch.init(num_cpus=2, _session_root={str(tmp_path / 'sess')!r})

def fast(x):
    return x + 1

def stall(x, gate={gate!r}):
    open(gate, "w").write("here")
    time.sleep(300)
    return x

n1 = ray_tpu_torch.remote(fast).bind(1)
n2 = ray_tpu_torch.remote(stall).bind(n1)
workflow.run(n2, workflow_id="wf_kill", storage={storage!r})
"""
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=REPO)
    try:
        deadline = time.time() + 120
        while not os.path.exists(gate) and time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(
                    f"driver exited early rc={proc.returncode}")
            time.sleep(0.2)
        assert os.path.exists(gate), "stall step never started"
        time.sleep(1.0)
    finally:
        proc.kill()
        proc.wait(timeout=60)
        _kill_workers_of(str(tmp_path / "sess"))

    def fast(x):
        return x + 1

    def stall(x, gate=gate):  # the resumed run does not stall
        return x * 10

    n1 = ray_tpu_torch.remote(fast).bind(1)
    n2 = ray_tpu_torch.remote(stall).bind(n1)
    out = workflow.resume(n2, workflow_id="wf_kill", storage=storage)
    assert out == 20
    assert os.path.isdir(os.path.join(storage, "wf_kill", "steps"))


def _kill_workers_of(session_root):
    """SIGKILL the worker processes a killed driver left behind: those
    whose session directory lies under `session_root`."""
    want = f"RAY_TPU_SESSION_DIR={session_root}".encode()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read()
            if want in env:
                os.kill(int(pid), signal.SIGKILL)
        except OSError:
            pass


def test_workflow_events_deliver_and_are_durable(tmp_path):
    """A step blocks on wait_for_event until send_event delivers; the
    payload is durable, so resume never waits again."""
    st = str(tmp_path / "wf")

    def combine(payload, base):
        return f"{base}-{payload}"

    ev = workflow.wait_for_event("go", timeout_s=60)
    node = ray_tpu_torch.remote(combine).bind(ev, "job")

    def deliver():
        time.sleep(1.0)
        workflow.send_event("wf_ev", "go", "payload42", storage=st)

    threading.Thread(target=deliver, daemon=True).start()
    t0 = time.time()
    out = workflow.run(node, workflow_id="wf_ev", storage=st)
    assert out == "job-payload42"
    assert time.time() - t0 >= 0.9  # it waited for the delivery
    ev2 = workflow.wait_for_event("go", timeout_s=1)
    node2 = ray_tpu_torch.remote(combine).bind(ev2, "job")
    assert workflow.resume(node2, workflow_id="wf_ev",
                           storage=st) == "job-payload42"


def test_workflow_event_timeout(tmp_path):
    ev = workflow.wait_for_event("never", timeout_s=1.0)
    with pytest.raises(Exception):
        workflow.run(ev, workflow_id="wf_to", storage=str(tmp_path / "wf"))


def test_workflow_resume_skips_completed_steps(tmp_path):
    marker = str(tmp_path / "exec_count")

    @ray_tpu_torch.remote
    def expensive(path, x):
        with open(path, "a") as f:
            f.write("x")
        return x * 2

    @ray_tpu_torch.remote
    def flaky(path, x):
        if not os.path.exists(path + ".fixed"):
            raise RuntimeError("transient failure")
        return x + 1

    with InputNode() as inp:
        dag = flaky.bind(marker, expensive.bind(marker, inp))

    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf1", storage=str(tmp_path),
                     dag_input=21)
    assert os.path.getsize(marker) == 1  # expensive completed once

    open(marker + ".fixed", "w").write("1")
    result = workflow.resume(dag, workflow_id="wf1", storage=str(tmp_path),
                             dag_input=21)
    assert result == 43
    assert os.path.getsize(marker) == 1, \
        "resume must not run the checkpointed step again"
    assert workflow.get_output("wf1", storage=str(tmp_path)) == 43
