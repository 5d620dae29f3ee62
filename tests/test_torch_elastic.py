"""Elasticity on the port, on the CPU: tests/test_elastic.py's tier-1 cases.

ScalingConfig's elastic bounds against the JAX package's on the same
arguments; the bounded re-form (infeasible -> TrainingWorkerError naming
the demand; partial formation above the minimum); a worker killed while
the gang forms, which spends the failure budget (the JAX package's
start() lets it out of fit()); the stuck-reconfiguration probe and the
tracker's snapshot; an elastic gloo learner gang of 2 that survives a
kill and a resize (Adam's step 1, 2, 3; shard_n 64, 64, 128); the
shrink-then-grow drill, a TorchTrainer under AutoscalerV2 over
LocalNodeProvider going 2 -> 1 -> 2 (the JAX drill goes 4 -> 3 -> 4:
fewer processes here, on a box other tests load); the two-way
partition that leaves its node alive, a defect of the JAX package and
the port alike (ROADMAP Queue 3), shown on both; and one seed of the
port's chaos sweep, --schedule elastic on the CPU.

One ray_tpu_torch.init(num_cpus=4) serves the cases up to the drill,
which shuts it down and runs its own Cluster; the drill waits on
progress, with deadlines at least three times its time alone.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import chaos
from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                 TorchConfig, TorchTrainer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_ownership_drains(timeout_s: float = 15.0) -> None:
    """The driver's lease slots and pins drain to zero (the port's copy
    of tests/conftest.py's canary)."""
    import gc

    from ray_tpu_torch._private import ownership
    from ray_tpu_torch._private import worker as worker_mod

    cw = worker_mod.global_worker().core_worker
    deadline = time.monotonic() + timeout_s
    leaks = []
    while time.monotonic() < deadline:
        gc.collect()
        with cw._lock:
            leaks = ownership.lease_drain_report(cw._ltab)
        if not leaks:
            return
        time.sleep(0.25)
    pytest.fail("ownership drains-to-zero canary failed: " + "; ".join(leaks))


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# ---- ScalingConfig's elastic bounds ---------------------------------------------

@pytest.mark.parametrize("kw", [
    {"num_workers": 4, "elastic_min_workers": 2},
    {"num_workers": 4},
    {"num_workers": 4, "elastic_min_workers": 5},
    {"num_workers": 4, "elastic_min_workers": 0},
    {"num_workers": 4, "elastic_max_workers": 6},
    {"num_workers": 4, "elastic_min_workers": 2, "elastic_max_workers": 3},
    {"num_workers": 4, "elastic_min_workers": 2, "elastic_max_workers": 6},
    {"num_workers": 2, "step_deadline_s": 0.0}])
def test_scaling_config_elastic_validation(kw):
    from ray_tpu.train import ScalingConfig as JScalingConfig

    def outcome(cls):
        try:
            cfg = cls(**kw)
        except ValueError:
            return "ValueError"
        return cfg.elastic, cfg.elastic_target_workers
    assert outcome(ScalingConfig) == outcome(JScalingConfig)
    if kw == {"num_workers": 4, "elastic_min_workers": 2}:
        assert outcome(ScalingConfig) == (True, 4)


# ---- the bounded re-form ---------------------------------------------------------

def test_infeasible_reform_raises_naming_demand(cluster):
    from ray_tpu_torch.train.backend import BackendConfig
    from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                      TrainingWorkerError)
    ex = BackendExecutor(
        BackendConfig(),
        ScalingConfig(num_workers=2,
                      resources_per_worker={"no_such_resource": 1.0},
                      elastic_min_workers=2, elastic_reform_timeout_s=2.0))
    with pytest.raises(TrainingWorkerError) as ei:
        ex.start()
    msg = str(ei.value)
    assert "0/2" in msg and "no_such_resource" in msg
    assert "elastic_min_workers=2" in msg
    ex.shutdown()
    assert_ownership_drains()


def test_partial_formation_proceeds_above_min(cluster):
    """Only one of two {CPU: 3} bundles fits on the 4-CPU node: the
    elastic gang forms at world 1 and keeps the other as a probe."""
    from ray_tpu_torch.train.backend import BackendConfig
    from ray_tpu_torch.train.backend_executor import BackendExecutor
    ex = BackendExecutor(
        BackendConfig(),
        ScalingConfig(num_workers=2, resources_per_worker={"CPU": 3.0},
                      elastic_min_workers=1, elastic_reform_timeout_s=3.0))
    ex.start()
    try:
        assert len(ex.worker_group) == 1
        assert len(ex.worker_group.pending_pgs) == 1
        assert ex.worker_group.missing_workers() == 1
        assert ex._contexts[0].world_size == 1
        assert ex.worker_group.probe_ready() is False
    finally:
        ex.shutdown()
    assert_ownership_drains()


def make_counting_loop():
    """A loop that reports its steps (nested: the workers cannot import
    this module, so cloudpickle ships it by value)."""

    def loop(config):
        from ray_tpu_torch import train
        for step in range(config["steps"]):
            train.report({"step": step})

    return loop


@pytest.mark.parametrize("elastic", [False, True])
def test_kill_while_the_gang_forms_spends_the_budget(cluster, elastic,
                                                     tmp_path):
    """A worker killed by its first dispatch (the gang's formation, before
    any step) costs one failure of the budget and the run completes, in
    a fixed gang and in an elastic one."""
    chaos.clear()
    rid = chaos.inject("kill_worker", actor_class="RayTrainWorker",
                       method="w_*", max_fires=1)
    scaling = {"elastic_min_workers": 1, "elastic_reform_timeout_s": 10.0} \
        if elastic else {}
    try:
        result = TorchTrainer(
            make_counting_loop(), train_loop_config={"steps": 3},
            torch_config=TorchConfig(backend="gloo"),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False,
                                         **scaling),
            run_config=RunConfig(
                storage_path=str(tmp_path), name="kill_forming",
                failure_config=FailureConfig(max_failures=2))).fit()
        fired = [r["fired"] for r in chaos.list_rules()
                 if r["rule_id"] == rid]
    finally:
        chaos.clear()
    assert fired == [1], "the kill never fired"
    assert result.error is None, f"run failed: {result.error!r}"
    assert result.metrics["step"] == 2
    assert_ownership_drains()


# ---- the probe and the tracker ---------------------------------------------------

def test_elastic_stuck_reconfig_probe_unit():
    from ray_tpu_torch._private.metrics_plane import Watchdog
    alerts = []

    def emit(event_type, message, severity="INFO", **fields):
        alerts.append((event_type, severity, fields))

    wd = Watchdog(emit=emit, cooldown_s=0.0, wait_edge_age_s=120.0,
                  store_occupancy_frac=0.95, queue_depth=256,
                  elastic_reconfig_s=5.0)

    def snap(age, in_progress=True):
        return {"proc_uid": "u1", "proc": "driver", "pid": 7, "metrics": [],
                "elastic:train": {"gang": "train", "in_progress": in_progress,
                                  "phase": "reform", "age_s": age,
                                  "reason": "worker_death",
                                  "reconfigs_total": 1}}

    wd._probe_elastic([snap(2.0)])
    wd._probe_elastic([snap(9.0, False)])
    assert alerts == []
    wd._probe_elastic([snap(9.0)])
    assert len(alerts) == 1
    event_type, severity, fields = alerts[0]
    assert event_type == "HEALTH_ALERT" and severity == "ERROR"
    assert fields["probe"] == "elastic_stuck_reconfig"
    assert fields["phase"] == "reform"


def test_reconfig_tracker_snapshot_and_metrics():
    from ray_tpu_torch.train.elastic import ReconfigTracker
    from ray_tpu_torch.util import metrics as metrics_mod
    tracker = ReconfigTracker("unit-test-gang")
    try:
        assert tracker.snapshot()["in_progress"] is False
        rec = tracker.start("worker_death", world_size=4)
        with rec.phase("drain"):
            pass
        snap = tracker.snapshot()
        assert snap["in_progress"] and snap["phase"] == "drain"
        assert snap["age_s"] >= 0.0
        for phase in ("checkpoint", "reform", "reshard", "resume"):
            with rec.phase(phase):
                pass
        rec.finish(world_size=3)
        assert tracker.snapshot()["in_progress"] is False
        assert tracker.reconfigs_total == 1
        h = tracker.history[-1]
        assert h["reason"] == "worker_death"
        assert h["from_world_size"] == 4 and h["to_world_size"] == 3
        assert set(h["phases_s"]) == {"drain", "checkpoint", "reform",
                                      "reshard", "resume"}
        counter = metrics_mod.get_or_create(
            metrics_mod.Counter, "ray_tpu_elastic_reconfigurations_total",
            tag_keys=("reason",))
        assert sum(counter.snapshot()["values"].values()) >= 1
        rec2 = tracker.start("scale_up", world_size=3)
        rec2.abort(RuntimeError("boom"))
        assert tracker.snapshot()["in_progress"] is False
        assert tracker.reconfigs_total == 1
    finally:
        tracker.close()


# ---- the elastic learner gang -----------------------------------------------------

def make_stub_factory():
    """A learner for the gang's machinery (fresh processes, a gloo
    process group a formation) whose update is numpy: `world` and
    `shard_n` in its stats say what the group and the reshard did, and
    its state carries Adam's step count as torch's optimizer state does
    (nested, so that cloudpickle ships it by value into the ranks)."""

    def factory():
        return StubLearner()

    class StubLearner:
        def __init__(self):
            self.params = np.zeros(4, np.float32)
            self.count = 0
            self.world = 0

        def target_device(self):
            import torch
            return torch.device("cpu")

        def build_distributed(self, seed=0):
            import torch.distributed as dist
            self.world = dist.get_world_size()

        def data_axis_for(self, key):
            return 0

        def update_distributed(self, batch, minibatch_size, num_iters, seed):
            x = batch["x"]      # this rank's shard
            self.params = self.params + float(x.mean())
            self.count += 1
            return {"total_loss": float(np.abs(x).mean()),
                    "world": float(self.world), "shard_n": float(len(x)),
                    "count": float(self.count)}

        def get_state(self):
            return {"params": self.params,
                    "opt_state": {"state": {0: {"step": np.float32(
                        self.count)}}, "param_groups": []}}

        def set_state(self, state):
            self.params = np.asarray(state["params"])
            self.count = int(state["opt_state"]["state"][0]["step"])

    return factory


def adam_step(state):
    return int(state["opt_state"]["state"][0]["step"])


def test_learner_group_elastic_kill_and_resize(cluster):
    """A gang of 2 survives a killed rank (drain, the cached state,
    re-form, reshard, retry): Adam's step reads 2, not 1; an explicit
    reconfigure(1) reshards to world 1 and training goes on."""
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
    batch = {"x": np.arange(128, dtype=np.float32)}
    gang = LearnerGroup(make_stub_factory(), num_learners=2, seed=11,
                        elastic_min_learners=1,
                        elastic_reform_timeout_s=120.0)
    try:
        s1 = gang.update(dict(batch), minibatch_size=None, num_iters=1,
                         seed=0)
        assert s1["world"] == 2.0 and s1["shard_n"] == 64.0
        assert adam_step(gang.get_state()) == 1
        ray_tpu_torch.kill(gang._actors[0])
        s2 = gang.update(dict(batch), minibatch_size=None, num_iters=1,
                         seed=1)
        assert len(gang._actors) == 2
        assert s2["world"] == 2.0 and s2["shard_n"] == 64.0
        assert adam_step(gang.get_state()) == 2
        assert gang._tracker.reconfigs_total == 1
        assert gang._tracker.history[-1]["reason"] == "worker_death"
        assert gang.reconfigure(1, reason="scale_down") == 1
        assert len(gang._actors) == 1
        s3 = gang.update(dict(batch), minibatch_size=None, num_iters=1,
                         seed=2)
        assert s3["world"] == 1.0 and s3["shard_n"] == 128.0
        assert adam_step(gang.get_state()) == 3
        assert gang._tracker.reconfigs_total == 2
        with pytest.raises(ValueError, match="below elastic_min_learners"):
            gang.reconfigure(0)
    finally:
        gang.shutdown()
    assert_ownership_drains()


# ---- the shrink-then-grow drill -------------------------------------------------

def make_elastic_loop():
    """The drill's loop (nested: cloudpickle ships it by value to the
    autoscaled node): a linear regression in torch, each rank's rows by
    world size, Adam, rank 0 checkpointing params, Adam's state and the
    step with torch.save into a pid-suffixed staging directory; a resumed
    gang loads them, Adam's step equal to the resume step; the full-batch
    loss goes to the progress file. The math stays per rank (the gloo
    group carries no collective), as the JAX drill's does."""

    def loop(config):
        import os as _os
        import time as _time

        import torch

        from ray_tpu_torch import train as T
        from ray_tpu_torch.train import Checkpoint as _Checkpoint

        ctx = T.get_context()
        rank, world = ctx.get_world_rank(), ctx.get_world_size()
        torch.set_num_threads(1)
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(24, 4, generator=gen)
        y = x @ torch.tensor([1.0, -2.0, 3.0, 0.5])
        w = torch.zeros(4, requires_grad=True)
        opt = torch.optim.Adam([w], lr=0.05)
        start = 0
        ckpt = T.get_checkpoint()
        if ckpt:
            state = torch.load(_os.path.join(ckpt.path, "state.pt"))
            with torch.no_grad():
                w.copy_(state["w"])
            opt.load_state_dict(state["opt"])
            start = state["step"] + 1
            got = int(opt.state_dict()["state"][0]["step"])
            assert got == start, (got, start)
        step = start
        while step < 100_000:  # the stop file ends the run
            xs, ys = x[rank::world], y[rank::world]
            loss = ((xs @ w - ys) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            with torch.no_grad():
                full = float(((x @ w - y) ** 2).mean())
            _time.sleep(0.02)  # paces the run so the drill lands mid-run
            if rank == 0:
                cdir = _os.path.join(config["base"],
                                     f"wip_{step}_{_os.getpid()}")
                _os.makedirs(cdir, exist_ok=True)
                torch.save({"w": w.detach().clone(),
                            "opt": opt.state_dict(), "step": step},
                           _os.path.join(cdir, "state.pt"))
                c = _Checkpoint(cdir)
                c.update_metadata({"step": step})
                with open(config["progress"], "a") as f:
                    f.write(f"{step} {world} {full:.8f}\n")
                T.report({"step": step, "world": world, "loss": full},
                         checkpoint=c)
            else:
                T.report({"step": step, "world": world, "loss": full})
            stop_at = None
            if _os.path.exists(config["stop_file"]):
                with open(config["stop_file"]) as f:
                    stop_at = int(f.read().strip() or 10 ** 9)
            step += 1
            if stop_at is not None and step >= stop_at:
                break

    return loop


def read_progress(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.split() for ln in f.read().splitlines() if ln]


def wait_progress(path, pred, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    rows = []
    while time.monotonic() < deadline:
        rows = read_progress(path)
        if rows and pred(rows):
            return rows
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}; progress tail: "
                         f"{rows[-8:]}")


def has_subsequence(seq, sub):
    it = iter(seq)
    return all(x in it for x in sub)


def test_chaos_driven_elastic_shrink_then_grow(tmp_path, monkeypatch):
    """A 2-worker TorchTrainer (gloo) whose second trainslot is a node
    AutoscalerV2 launches; a chaos kill_worker of that node's worker, a
    partition of the node and then the host's end (a preemption) shrink
    it to world 1, resumed from the checkpoint; the autoscaler replaces
    the node and the gang grows back to 2, with no fresh start."""
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch.autoscaler import LocalNodeProvider, NodeType
    from ray_tpu_torch.autoscaler.v2 import (RAY_RUNNING, TERMINATED,
                                             AutoscalerV2,
                                             ClusterStatusReader)
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import state as state_api

    monkeypatch.setattr(Config, "health_check_period_s", 0.5)
    progress = str(tmp_path / "progress")
    stop_file = str(tmp_path / "stop_at")
    ray_tpu_torch.shutdown()  # its own cluster: the drill preempts a node
    cluster = Cluster(initialize_head=True, connect=False,
                      head_node_args={"num_cpus": 4,
                                      "resources": {"trainslot": 1}})
    scaler = None
    fit_result = []
    try:
        cluster.connect()
        chaos.clear()

        class SlowRebootProvider(LocalNodeProvider):
            """The first boot is instant; a replacement boots once the
            gang has taken two steps at world 1 (at most after 120 s), so
            that it runs below its target for a while however long its
            processes take to start (the JAX drill sleeps 10 s)."""

            def __init__(self, addr):
                super().__init__(addr)
                self.boots = 0

            def create_node(self, resources):
                self.boots += 1
                if self.boots > 1:
                    deadline = time.monotonic() + 120
                    while time.monotonic() < deadline and sum(
                            1 for r in read_progress(progress)
                            if r[1] == "1") < 2:
                        time.sleep(0.2)
                return super().create_node(resources)

        scaler = AutoscalerV2(
            ClusterStatusReader(cluster.address),
            SlowRebootProvider(cluster.address),
            [NodeType("train", {"trainslot": 1.0, "CPU": 1.0})],
            max_nodes=2, idle_timeout_s=300.0, gcs_address=cluster.address,
            poll_period_s=1.0)
        scaler.start()
        trainer = TorchTrainer(
            make_elastic_loop(),
            train_loop_config={"base": str(tmp_path), "progress": progress,
                               "stop_file": stop_file},
            torch_config=TorchConfig(backend="gloo"),
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=False,
                resources_per_worker={"trainslot": 1.0},
                elastic_min_workers=1, elastic_reform_timeout_s=15.0),
            run_config=RunConfig(
                storage_path=str(tmp_path), name="elastic_e2e",
                failure_config=FailureConfig(max_failures=4)))
        t = threading.Thread(target=lambda: fit_result.append(trainer.fit()),
                             daemon=True)
        t.start()

        # (1) world 2 once the autoscaler's node has joined
        wait_progress(progress, lambda rows: rows and rows[-1][1] == "2"
                      and int(rows[-1][0]) >= 2, 180, "world-2 training")
        victims = [i for i in scaler.im.instances.values()
                   if i.status == RAY_RUNNING]
        assert victims, "autoscaler supplied no node"
        victim_node = victims[0].node_id_hex
        steps_before = len(open(progress).read().splitlines())
        # (2) preempt it: kill its worker and cut it off the head both
        # ways; once the kill has landed the host goes (the provider ends
        # it). Ending the host is also the workaround for the defect
        # test_two_way_partition_leaves_the_node_alive shows: the
        # partitioned node reads alive, so a gang re-formed at once could
        # land on it again
        kill = chaos.inject("kill_worker", actor_class="RayTrainWorker",
                            node_id=victim_node, max_fires=1)
        chaos.inject("partition",
                     nodes=(cluster.head_node.node_id_hex, victim_node))
        deadline = time.monotonic() + 60
        while not (any(r["rule_id"] == kill and r["fired"]
                       for r in chaos.list_rules()) or any(
                "RayTrainWorker" in a["class_name"]
                and a["node_id"] == victim_node and a["state"] == "DEAD"
                for a in state_api.list_actors())):
            # (a worker that kills itself can die before its fire's
            # one-way report leaves)
            assert time.monotonic() < deadline, "the kill never fired"
            time.sleep(0.1)
        scaler.im.provider.terminate_node(victims[0].provider_node)
        wait_progress(progress, lambda rows: rows[-1][1] == "1"
                      and len(rows) >= steps_before + 2, 180,
                      "world-1 resume after preemption")
        # (3) the replacement node: back to world 2
        rows = wait_progress(
            progress, lambda rows: rows[-1][1] == "2" and sum(
                1 for r in rows[steps_before:] if r[1] == "2") >= 2,
            240, "world-2 re-grow")
        # every rank stops once its step reaches the file's; rank 1 (no
        # progress file) may run up to two report rounds ahead of rank 0,
        # and a rank already past the file's step would report more
        # rounds than its peer
        with open(stop_file, "w") as f:
            f.write(str(int(rows[-1][0]) + 8))
        t.join(timeout=180)
        assert not t.is_alive(), "fit() did not finish after stop"
        result = fit_result[0]
        assert result.error is None, f"run failed: {result.error!r}"

        rows = read_progress(progress)
        worlds = [int(r[1]) for r in rows]
        steps = [int(r[0]) for r in rows]
        shape = [w for w, prev in zip(worlds, [None] + worlds[:-1])
                 if w != prev]
        assert worlds[-1] == 2, worlds[-20:]
        assert has_subsequence(shape, [2, 1, 2]), shape
        assert steps[0] == 0 and steps.count(0) == 1, \
            f"restarted from scratch: {steps[:10]}"
        assert len(steps) > len(set(steps)), "no step re-ran"
        # a re-run step starts from the checkpoint: its loss may move by
        # one step on other rows, not snap back to the first loss
        init_loss = float(rows[0][2])
        by_step = {}
        for r in rows:
            by_step.setdefault(int(r[0]), []).append(float(r[2]))
        rerun = {s: ls for s, ls in by_step.items() if len(ls) > 1}
        assert rerun
        for s, ls in rerun.items():
            assert max(ls) - min(ls) < 0.05 * init_loss, (s, ls, init_loss)

        from ray_tpu_torch.util import metrics as metrics_mod
        counter = metrics_mod.get_or_create(
            metrics_mod.Counter, "ray_tpu_elastic_reconfigurations_total",
            tag_keys=("reason",))
        reasons = {dict(k).get("reason"): v
                   for k, v in counter.snapshot()["values"].items()}
        assert reasons.get("worker_death", 0) >= 1, reasons
        assert reasons.get("scale_up", 0) >= 1, reasons

        from ray_tpu_torch._private import spans as spans_mod
        from ray_tpu_torch._private import worker as worker_mod
        names = [str(e.get("name", "")) for e in spans_mod.merge_snapshots(
            worker_mod.global_worker().core_worker._gcs.call(
                "spans_collect"))]
        for phase in ("elastic.drain", "elastic.checkpoint",
                      "elastic.reform", "elastic.reshard", "elastic.resume"):
            assert names.count(phase) >= 2, phase
        assert "elastic.detect" in names

        statuses = [i.status for i in scaler.im.instances.values()]
        assert TERMINATED in statuses and RAY_RUNNING in statuses
        out = state_api.autoscaler_instances()
        assert any(e["to"] == RAY_RUNNING for e in out["events"])
        assert_ownership_drains()
    finally:
        try:
            chaos.clear()
        except Exception:  # noqa: BLE001 - cluster going down anyway
            pass
        if scaler is not None:
            scaler.stop()
            for node in scaler.im.provider.non_terminated_nodes():
                try:
                    scaler.im.provider.terminate_node(node)
                except Exception:  # noqa: BLE001 - already dead
                    pass
        cluster.shutdown()


# ---- the partition defect (ROADMAP Queue 3), shared with the reference -----------

_PARTITION_SCRIPT = """
import importlib, json, sys, time
pkg = sys.argv[1]
rt = importlib.import_module(pkg)
chaos = importlib.import_module(pkg + ".chaos")
Config = importlib.import_module(pkg + "._private.config").Config
Cluster = importlib.import_module(pkg + ".cluster_utils").Cluster
rpc = importlib.import_module(pkg + "._private.rpc")
Config.health_check_period_s = 0.5
cluster = Cluster(initialize_head=True, connect=False,
                  head_node_args={"num_cpus": 1})
try:
    cluster.connect()
    node = cluster.add_node(num_cpus=1)
    head, gcs = cluster.head_node.node_id_hex, cluster._head.gcs
    rid = chaos.inject("partition", nodes=(head, node.node_id_hex))
    host, port = node.node_manager_address.rsplit(":", 1)
    try:
        gcs._pool.get((host, int(port))).call("nm_ping")
        probe_fails = False
    except rpc.ConnectionLost:
        probe_fails = True
    head_side = {tuple(a) for a in gcs.chaos_rules[rid]["node_addrs"][head]}
    time.sleep(10 * Config.health_check_period_s)
    alive = {n["NodeID"]: n["Alive"] for n in rt.nodes()}
    print(json.dumps({
        "probe_fails": probe_fails,
        "gcs_on_head_side": tuple(gcs.address) in head_side,
        "failures": gcs.node_health_failures[node.node_id_hex],
        "threshold": gcs.HEALTH_CHECK_FAILURES_TO_DEAD,
        "alive": alive[node.node_id_hex]}))
finally:
    chaos.clear()
    cluster.shutdown()
"""


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_two_way_partition_leaves_the_node_alive(pkg):
    """The defect the drills work round by ending the host: a chaos
    partition of a node from the head drops the calls between the two
    nodes' node managers and stores, so the GCS's health probe of the
    node fails; but the head's side lists no GCS address, so the node's
    resource reports still reach the GCS, and each one resets the
    probe's failure count. Ten probe periods on, the node reads alive,
    in the JAX package and in the port alike."""
    proc = subprocess.run(
        [sys.executable, "-c", _PARTITION_SCRIPT, pkg],
        capture_output=True, text=True, timeout=90, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, proc.stdout + proc.stderr[-3000:]
    import json
    out = json.loads(lines[-1])
    assert out["probe_fails"], out
    assert not out["gcs_on_head_side"], out
    assert out["failures"] < out["threshold"], out
    assert out["alive"], out


# ---- the port's chaos sweep ------------------------------------------------------

def test_chaos_sweep_elastic_smoke():
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.chaos_sweep",
         "--schedule", "elastic", "--device", "cpu", "--format", "json",
         "--seeds", "3", "--timeout", "300"],
        capture_output=True, text=True, timeout=420, cwd=REPO)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert lines, proc.stdout[-2000:] + proc.stderr[-2000:]
    import json
    out = json.loads(lines[-1])
    assert out["schedule"] == "elastic"
    assert out["failed_seeds"] == [], out
