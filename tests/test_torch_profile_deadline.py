"""The profile collect's deadlines in device mode (the port's repaired
copies of _private/node_manager.py and _private/gcs.py; the edits are in
test_torch_runtime.py's REPAIRED), on the CPU, without a cluster.

A device trace is written out after its window, in time that grows with
what the window recorded, so `util.state.profile(device=True)` waits
profiler.device_export_s(duration) beyond the CPU sampler's deadlines at
each hop: a node manager pulls its workers for the window plus its grace
plus that, the GCS gathers the node managers for the window plus its
(larger) grace plus that. The CPU collect keeps the reference's
deadlines. The handlers run unbound on stand-ins of their objects, with
the gathers replaced by recorders.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest

from ray_tpu._private import node_manager as ref_node_manager
from ray_tpu_torch._private import gcs, node_manager, profiler, spans

WINDOW_S = 2.0


def _node(module):
    return SimpleNamespace(
        _lock=threading.Lock(), workers={},
        node_id=SimpleNamespace(hex=lambda: "n0"),
        PROFILE_WORKER_GRACE_S=module.NodeManager.PROFILE_WORKER_GRACE_S)


def _node_timeout(module, spans_module, monkeypatch, device):
    seen = []

    def pull(addrs, method, timeout, grace_s=1.0, call_kwargs=None):
        seen.append(timeout)
        return []

    monkeypatch.setattr(spans_module, "pull_snapshots", pull)
    module.NodeManager.profile_collect(_node(module), duration_s=WINDOW_S,
                                       hz=50.0, device=device)
    (timeout,) = seen
    return timeout


@pytest.mark.parametrize("device", [False, True])
def test_node_manager_waits_for_a_device_trace_to_be_written(monkeypatch,
                                                              device):
    grace = node_manager.NodeManager.PROFILE_WORKER_GRACE_S
    export = profiler.device_export_s(WINDOW_S) if device else 0.0
    assert _node_timeout(node_manager, spans, monkeypatch, device) == \
        WINDOW_S + grace + export


def test_the_reference_node_manager_leaves_no_room_to_write_it(monkeypatch):
    """The JAX package's copy pulls a device trace under the CPU
    sampler's deadline: the window plus 5 s."""
    from ray_tpu._private import spans as ref_spans
    assert _node_timeout(ref_node_manager, ref_spans, monkeypatch,
                         True) == WINDOW_S + 5.0


@pytest.mark.parametrize("device", [False, True])
def test_gcs_waits_for_the_node_managers(monkeypatch, device):
    seen = []

    def gather(gcs_server, nm_method, cw_method, timeout, grace_s=1.0,
               call_kwargs=None, concurrent=False):
        seen.append(timeout)
        return [], [], []

    monkeypatch.setattr(spans, "gather_cluster_snapshots", gather)
    monkeypatch.setattr(profiler, "collect_local",
                        lambda duration_s, hz: None)
    fake = SimpleNamespace(
        PROFILE_COLLECT_GRACE_S=gcs.GcsServer.PROFILE_COLLECT_GRACE_S)
    out = gcs.GcsServer.profile_collect(fake, duration_s=WINDOW_S, hz=50.0,
                                        device=device)
    assert out["profiles"] == [] and out["device"] is device
    export = profiler.device_export_s(WINDOW_S) if device else 0.0
    assert seen == [WINDOW_S + gcs.GcsServer.PROFILE_COLLECT_GRACE_S
                    + export]
    # the node managers' pulls end before the GCS stops waiting for them
    assert seen[0] > WINDOW_S + \
        node_manager.NodeManager.PROFILE_WORKER_GRACE_S + export


# seconds a capture of a GPT-2-125M training loop answered beyond its
# window, by window, on an H100 (chip_profile_export.py)
EXPORT_READINGS = {2.0: 7.46, 10.0: 21.18, 30.0: 59.29}


def test_export_time_grows_with_the_window():
    for window, beyond in EXPORT_READINGS.items():
        assert profiler.device_export_s(window) >= 2 * beyond, window
    assert profiler.device_export_s(120.0) > profiler.device_export_s(30.0)


def test_the_export_measurement_needs_a_card():
    """chip_profile_export.py, which takes the readings behind
    device_export_s, exits non-zero and prints no result without one."""
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "chip_profile_export.py"],
        cwd=repo, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "captures" not in out.stdout
