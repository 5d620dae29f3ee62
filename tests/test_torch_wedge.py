"""The collective-wedge watchdog on the port, on the CPU: tests/test_wedge.py's
tier-1 cases.

The step deadline and its calibration; stale ranks and the rank/slice
classification (each against the JAX package's function on the same
reply); the gang_rank_wedged probe; the heartbeat table's GC on a
standalone GcsServer, its round trip through the port's GCS and the
sidecar sender; the learner gang's supervisor (_await_update) tripping on
an expired deadline with a stale heartbeat and waiting on a slow rank
whose heartbeats stay fresh; a slow-but-alive elastic TorchTrainer that
never trips; one seed of the port's chaos sweep, --schedule wedge on the
CPU. The SIGSTOP flagship is left out (ROADMAP watches it as
timing-bound); its learner counterpart runs on the card in
chip_smoke.py's phase "elastic". One ray_tpu_torch.init(num_cpus=4) for
the module.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu.train import heartbeat as jhb
from ray_tpu_torch import chaos
from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                 TorchConfig, TorchTrainer)
from ray_tpu_torch.train.heartbeat import (HeartbeatSender, StepDeadline,
                                           classify_wedge, stale_ranks)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _gcs():
    from ray_tpu_torch._private import worker as worker_mod
    return worker_mod.global_worker().core_worker._gcs


# ---- the step deadline ------------------------------------------------------------

def test_step_deadline_explicit_and_override():
    d = StepDeadline(3.0)
    assert d.current() == 3.0
    assert d.current(override_s=7.5) == 7.5
    assert d.current(override_s=None) == 3.0
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            StepDeadline(bad)


def test_step_deadline_auto_calibration():
    ours = StepDeadline(None, k=4.0, floor_s=5.0, window=8, min_samples=3)
    theirs = jhb.StepDeadline(None, k=4.0, floor_s=5.0, window=8,
                              min_samples=3)
    trail = []
    for step_s in [0.1] * 3 + [10.0] * 8:
        ours.observe(step_s)
        theirs.observe(step_s)
        assert ours.current() == theirs.current()
        trail.append(ours.current())
    assert trail[:2] == [None, None] and trail[2] == 5.0
    assert trail[-1] == pytest.approx(40.0)
    assert len(ours._samples) == 8
    assert ours.current(override_s=2.0) == 2.0


# ---- staleness and classification -------------------------------------------------

def _reply(rows):
    return {"gang": "g", "ranks": rows, "step_deadline_override_s": None}


def test_stale_ranks_threshold():
    reply = _reply({0: {"age_s": 0.4, "node_id": "a", "pid": 1},
                    1: {"age_s": 12.0, "node_id": "a", "pid": 2},
                    2: {"age_s": 9.9, "node_id": "b", "pid": 3}})
    for threshold in (10.0, 15.0, 0.1):
        assert stale_ranks(reply, threshold) == \
            jhb.stale_ranks(reply, threshold)
    stale = stale_ranks(reply, 10.0)
    assert [r["rank"] for r in stale] == [1] and stale[0]["pid"] == 2
    assert stale_ranks(reply, 15.0) == []


@pytest.mark.parametrize("ages,want", [
    ((12.0, 0.1, 0.1), {"kind": "rank_wedge", "ranks": [0], "nodes": []}),
    ((12.0, 13.0, 0.1), {"kind": "slice_leave", "ranks": [0, 1],
                         "nodes": ["a"]})])
def test_classify_wedge_rank_vs_slice(ages, want):
    reply = _reply({r: {"age_s": age, "node_id": node}
                    for r, (age, node) in enumerate(zip(ages, "aab"))})
    got = classify_wedge(reply, stale_ranks(reply, 10.0))
    assert got == jhb.classify_wedge(reply, jhb.stale_ranks(reply, 10.0))
    assert got == want


def test_gang_rank_wedged_probe_unit():
    from ray_tpu_torch._private.metrics_plane import Watchdog
    alerts = []

    def emit(event_type, message, severity="INFO", **fields):
        alerts.append((event_type, severity, fields))

    wd = Watchdog(emit=emit, cooldown_s=0.0, wait_edge_age_s=120.0,
                  store_occupancy_frac=0.95, queue_depth=256,
                  gang_heartbeat_stale_s=10.0)
    fresh = {"ray_tpu_gang_heartbeat_age_seconds{gang=t:1,rank=0}": 0.6,
             "ray_tpu_gang_heartbeat_age_seconds{gang=t:1,rank=1}": 9.9}
    wd._probe_gang_wedge(fresh)
    assert alerts == []
    stale = dict(fresh)
    stale["ray_tpu_gang_heartbeat_age_seconds{gang=t:1,rank=1}"] = 14.2
    wd._probe_gang_wedge(stale)
    assert len(alerts) == 1
    event_type, severity, fields = alerts[0]
    assert event_type == "HEALTH_ALERT" and severity == "ERROR"
    assert fields["probe"] == "gang_rank_wedged"
    assert fields["gang"] == "t:1" and fields["rank"] == "1"
    assert fields["value"] == 14.2


# ---- the heartbeat table -----------------------------------------------------------

def test_abandoned_heartbeat_rows_are_gcd():
    """A formation torn down without a clear must not read as wedged
    forever: rows past the abandon horizon go (standalone GcsServer)."""
    from ray_tpu_torch._private.gcs import GcsServer
    gcs = GcsServer()
    try:
        gcs.gang_heartbeat(gang="dead:1", rank=0, step=3, phase="update",
                           node_id="", pid=1)
        gcs.gang_heartbeat(gang="live:1", rank=0, step=1, phase="update",
                           node_id="", pid=2)
        with gcs._lock:
            gcs.gang_heartbeats_tbl["dead:1"][0]["recv_mono"] -= \
                gcs.GANG_HEARTBEAT_ABANDON_S + 1.0
        rows = gcs._gang_heartbeat_rows()
        assert [(g, r) for g, r, _a in rows] == [("live:1", 0)]
        with gcs._lock:
            assert "dead:1" not in gcs.gang_heartbeats_tbl
        assert gcs._gang_heartbeat_rows()[0][0] == "live:1"
        assert "live:1" in str(gcs.gang_heartbeat_age_series())
    finally:
        gcs.shutdown()


def test_gang_heartbeat_gcs_roundtrip(cluster):
    from ray_tpu_torch.util import state as state_api
    g = _gcs()
    gang = "unit:roundtrip"
    try:
        g.call("gang_heartbeat", gang=gang, rank=0, step=7, phase="train",
               node_id="nodeA", pid=1234)
        reply = g.call("gang_heartbeats", gang=gang)
        rec = reply["ranks"][0]
        assert rec["step"] == 7 and rec["phase"] == "train"
        assert rec["pid"] == 1234 and 0.0 <= rec["age_s"] < 5.0
        assert rec["nm_address"] is None
        g.call("gang_heartbeat", gang=gang, rank=0, step=8, phase="train",
               node_id="nodeA", pid=1234)
        assert g.call("gang_heartbeats", gang=gang)["ranks"][0]["step"] == 8
        assert reply["step_deadline_override_s"] is None
        assert state_api.metrics_configure(
            step_deadline_s=7.25)["step_deadline_s"] == 7.25
        assert g.call("gang_heartbeats", gang=gang)[
            "step_deadline_override_s"] == 7.25
        state_api.metrics_configure(step_deadline_s=0)
        assert g.call("gang_heartbeats", gang=gang)[
            "step_deadline_override_s"] is None
        assert g.call("gang_heartbeat_clear", gang=gang) is True
        assert g.call("gang_heartbeats", gang=gang)["ranks"] == {}
    finally:
        g.call("gang_heartbeat_clear", gang=gang)
        g.call("metrics_configure", step_deadline_s=0)


def test_heartbeat_sender_beats_from_sidecar_thread(cluster):
    gang = "unit:sender"
    hb = HeartbeatSender(gang, rank=3, period_s=0.1)
    try:
        assert hb.start()
        hb.note_step(41)
        hb.note_step()
        hb.set_phase("train")
        deadline = time.monotonic() + 10
        rec = None
        while time.monotonic() < deadline:
            ranks = _gcs().call("gang_heartbeats", gang=gang)["ranks"]
            if 3 in ranks and ranks[3]["step"] == 42:
                rec = ranks[3]
                break
            time.sleep(0.05)
        assert rec is not None, "sidecar never beat"
        assert rec["phase"] == "train" and rec["pid"] == os.getpid()
        assert rec["age_s"] < 5.0
    finally:
        hb.stop()
        _gcs().call("gang_heartbeat_clear", gang=gang)


# ---- the learner gang's supervisor ------------------------------------------------

def _supervisor(uid, age_s):
    """A LearnerGroup holding only its supervisor's state, against a
    synthetic heartbeat reply of one rank `age_s` old."""
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
    gang = object.__new__(LearnerGroup)
    gang._gang_uid = uid
    gang._step_deadline = StepDeadline(0.5)
    gang._query_heartbeats = lambda: {
        "gang": uid, "step_deadline_override_s": None,
        "ranks": {0: {"age_s": age_s, "node_id": "n", "pid": 0,
                      "nm_address": None, "step": 1, "phase": "update"}}}
    return gang


def test_learner_await_update_trips_unit(cluster):
    """Deadline expired AND a stale heartbeat: GangWedgedError well
    before the update's own timeout."""
    from ray_tpu_torch.train.backend_executor import GangWedgedError

    @ray_tpu_torch.remote
    def hang(s):
        time.sleep(s)
        return "done"

    gang = _supervisor("learner:unittrip", 99.0)
    ref = hang.remote(6.0)
    t0 = time.monotonic()
    with pytest.raises(GangWedgedError, match="wedged mid-update"):
        gang._await_update([ref], timeout=60.0)
    assert time.monotonic() - t0 < 10.0
    assert ray_tpu_torch.get(ref, timeout=30) == "done"


def test_learner_await_update_slow_but_alive(cluster):
    """Fresh heartbeats keep the supervisor waiting past the deadline;
    the round's time feeds the calibrator."""
    @ray_tpu_torch.remote
    def slowstep():
        time.sleep(3.0)
        return "stepped"

    gang = _supervisor("learner:unitslow", 0.2)
    assert gang._await_update([slowstep.remote()], timeout=60.0) == \
        ["stepped"]
    assert len(gang._step_deadline._samples) == 1


def make_slow_loop():
    """Every step outlasts the 1 s deadline (nested: shipped by value)."""

    def loop(config):
        import time as _time

        from ray_tpu_torch import train as _train
        for step in range(config["steps"]):
            _time.sleep(1.6)
            _train.report({"step": step})

    return loop


def test_slow_but_alive_gang_never_trips(cluster, tmp_path):
    from ray_tpu_torch.util import metrics as metrics_mod

    def wedges():
        counter = metrics_mod.get_or_create(
            metrics_mod.Counter, "ray_tpu_elastic_reconfigurations_total",
            tag_keys=("reason",))
        return sum(v for k, v in counter.snapshot()["values"].items()
                   if dict(k).get("reason") == "wedge")

    before = wedges()
    chaos.clear()
    result = TorchTrainer(
        make_slow_loop(), train_loop_config={"steps": 3},
        torch_config=TorchConfig(backend="gloo"),
        scaling_config=ScalingConfig(
            num_workers=2, use_gpu=False, resources_per_worker={"CPU": 1},
            elastic_min_workers=1, step_deadline_s=1.0),
        run_config=RunConfig(storage_path=str(tmp_path), name="slow_alive",
                             failure_config=FailureConfig(max_failures=1))
    ).fit()
    assert result.error is None, f"slow-but-alive run failed: " \
                                 f"{result.error!r}"
    assert result.metrics["step"] == 2
    assert wedges() == before, "slow-but-alive steps tripped the wedge"


# ---- the port's chaos sweep -------------------------------------------------------

def test_chaos_sweep_wedge_smoke():
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.chaos_sweep",
         "--schedule", "wedge", "--device", "cpu", "--format", "json",
         "--seeds", "1", "--timeout", "240"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert lines, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(lines[-1])
    assert out["schedule"] == "wedge"
    assert out["failed_seeds"] == [], out
