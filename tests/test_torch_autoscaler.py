"""The port's autoscaler (ray_tpu_torch/autoscaler/: the demand
scheduler, StandardAutoscaler, the GKE TPU provider and the v2 instance
lifecycle), on the CPU.

Mirrors tests/test_autoscaler_demand.py, tests/test_autoscaler_v2_lifecycle.py
and tests/test_gke_provider.py case for case: each case runs on the
port's modules with the reference's assertions, and wherever it is a pure
function of its inputs (bin-packing, the provider's launches and
terminations, the lifecycle's edges and events, the status reader's
view, gcloud's arguments), the same case runs on the JAX package's
modules and the two records must be equal. Node ids and pool names are
random in both packages, so a record holds their shapes, not their
values. The cluster cases (the GCS report, PG demand, and
tests/test_ops_tooling.py's memory monitor and its real-node scale-up
and idle scale-down, here with a 5 s idle timeout) run on one
ray_tpu_torch.init(num_cpus=1) for the module.
"""

import importlib
import time
from types import SimpleNamespace

import pytest

import ray_tpu_torch


def _package(root):
    """The autoscaler of package `root` as one namespace."""
    ns = {}
    for mod in ("autoscaler.demand_scheduler", "autoscaler.autoscaler",
                "autoscaler.v2"):
        ns.update(vars(importlib.import_module(f"{root}.{mod}")))
    return SimpleNamespace(**ns)


PORT = _package("ray_tpu_torch")
JAX = _package("ray_tpu")


def both(case):
    """Run `case` on the port and on the JAX package; their records must
    be equal. Returns the port's."""
    got = case(PORT)
    assert got == case(JAX)
    return got


def test_the_port_runs_its_own_modules():
    assert PORT.AutoscalerV2.__module__ == "ray_tpu_torch.autoscaler.v2"
    assert PORT.get_nodes_to_launch.__module__ == \
        "ray_tpu_torch.autoscaler.demand_scheduler"
    assert PORT.NodeType is not JAX.NodeType


# ---- tests/test_autoscaler_demand.py: bin-packing ---------------------------

def test_packs_onto_existing_capacity_first():
    def case(A):
        return A.get_nodes_to_launch([{"CPU": 1}, {"CPU": 1}], [{"CPU": 4}],
                                     [A.NodeType("cpu4", {"CPU": 4})])
    assert both(case) == ({}, [])


def test_launches_smallest_fitting_type():
    def case(A):
        return A.get_nodes_to_launch(
            [{"CPU": 1}], [], [A.NodeType("big", {"CPU": 64, "TPU": 4}),
                               A.NodeType("small", {"CPU": 4})])
    assert both(case)[0] == {"small": 1}


def test_heterogeneous_demands_pack_into_mixed_types():
    def case(A):
        return A.get_nodes_to_launch(
            [{"CPU": 1}] * 6 + [{"TPU": 4, "CPU": 1}], [],
            [A.NodeType("cpu4", {"CPU": 4}),
             A.NodeType("tpu", {"TPU": 4, "CPU": 8})])
    to_launch, unplaceable = both(case)
    assert unplaceable == []
    assert to_launch["tpu"] == 1 and to_launch.get("cpu4", 0) <= 2
    assert to_launch.get("cpu4", 0) * 4 + to_launch["tpu"] * 8 >= 7


def test_respects_type_max_workers():
    def case(A):
        return A.get_nodes_to_launch(
            [{"CPU": 4}] * 5, [],
            [A.NodeType("cpu4", {"CPU": 4}, max_workers=2)])
    to_launch, unplaceable = both(case)
    assert to_launch == {"cpu4": 2} and len(unplaceable) == 3


def test_respects_max_total_nodes():
    def case(A):
        return A.get_nodes_to_launch(
            [{"CPU": 4}] * 5, [], [A.NodeType("cpu4", {"CPU": 4})],
            max_total_nodes=3)
    to_launch, unplaceable = both(case)
    assert sum(to_launch.values()) == 3 and len(unplaceable) == 2


def test_oversize_demand_unplaceable():
    def case(A):
        return A.get_nodes_to_launch([{"CPU": 128}], [],
                                     [A.NodeType("cpu4", {"CPU": 4})])
    assert both(case) == ({}, [{"CPU": 128}])


def test_pg_strict_pack_merges_bundles():
    def case(A):
        return [A.PlacementGroupDemand(bundles=[{"CPU": 2}, {"CPU": 2}],
                                       strategy=s).expand()
                for s in ("STRICT_PACK", "SPREAD", "PACK")]
    strict, spread, _ = both(case)
    assert strict == [{"CPU": 4}] and len(spread) == 2


# ---- StandardAutoscaler over the fake provider --------------------------------

def _v1(A, load, **kw):
    provider = A.FakeMultiNodeProvider()
    scaler = A.StandardAutoscaler("", provider, load_fn=lambda: dict(load),
                                  idle_timeout_s=0.0, **kw)
    return scaler, provider


def test_scales_up_for_shaped_demand():
    def case(A):
        scaler, provider = _v1(
            A, {"pending_shapes": [{"CPU": 1}] * 5, "available": [],
                "busy_by_node": {}},
            max_workers=4, node_types=[A.NodeType("cpu2", {"CPU": 2})])
        scaler.run_once()
        return len(provider.non_terminated_nodes()), provider.created_shapes
    n, shapes = both(case)
    assert n == 3 and all(s == {"CPU": 2} for s in shapes)


def test_tpu_demand_launches_tpu_type():
    def case(A):
        scaler, provider = _v1(
            A, {"pending_shapes": [{"TPU": 4}], "available": [],
                "busy_by_node": {}},
            max_workers=4, node_types=[A.NodeType("cpu2", {"CPU": 2}),
                                       A.NodeType("v5p", {"TPU": 4,
                                                          "CPU": 8})])
        scaler.run_once()
        return provider.created_shapes
    assert both(case) == [{"TPU": 4, "CPU": 8}]


def test_no_demand_no_launch_then_idle_scale_down():
    def case(A):
        load = {"pending_shapes": [], "available": [], "busy_by_node": {}}
        scaler, provider = _v1(A, load, max_workers=4)
        scaler.run_once()
        before = len(provider.non_terminated_nodes())
        node = provider.create_node({"CPU": 2})
        load["busy_by_node"] = {node.node_id_hex: 0}
        scaler.run_once()
        return before, len(provider.non_terminated_nodes()), \
            scaler.num_scale_downs
    assert both(case) == (0, 0, 1)


def test_existing_capacity_suppresses_launch():
    def case(A):
        scaler, provider = _v1(
            A, {"pending_shapes": [{"CPU": 1}], "available": [{"CPU": 8}],
                "busy_by_node": {}}, max_workers=4)
        scaler.run_once()
        return len(provider.non_terminated_nodes())
    assert both(case) == 0


# ---- AutoscalerV2 over the fake provider --------------------------------------

class _Reader:
    def __init__(self, A):
        self.status = A.ClusterStatus()

    def read(self):
        return self.status


def _v2(A, max_nodes=4):
    provider = A.FakeMultiNodeProvider()
    reader = _Reader(A)
    scaler = A.AutoscalerV2(
        reader, provider, [A.NodeType("cpu2", {"CPU": 2}),
                           A.NodeType("tpu4", {"TPU": 4, "CPU": 8})],
        max_nodes=max_nodes, idle_timeout_s=0.0)
    return scaler, provider, reader


def test_instance_lifecycle_to_running():
    def case(A):
        scaler, provider, reader = _v2(A)
        reader.status.pending_demands = [{"CPU": 1}]
        scaler.run_once()
        (inst,) = scaler.im.instances.values()
        first = (inst.status, list(inst.status_history))
        reader.status.pending_demands = []
        reader.status.alive_node_ids = [inst.node_id_hex]
        reader.status.busy_node_ids = [inst.node_id_hex]
        scaler.run_once()
        return first, inst.status
    (status, history), after = both(case)
    assert status == PORT.ALLOCATED and PORT.REQUESTED in history
    assert after == PORT.RAY_RUNNING


def test_mixed_demand_launches_by_type():
    def case(A):
        scaler, provider, reader = _v2(A)
        reader.status.pending_demands = [{"CPU": 1}, {"TPU": 4}]
        scaler.run_once()
        return (sorted(str(s) for s in provider.created_shapes),
                sorted(i.node_type for i in scaler.im.instances.values()))
    shapes, types = both(case)
    assert any("TPU" in s for s in shapes) and "tpu4" in types


def test_idle_scale_down_and_vanished_node():
    def case(A):
        scaler, provider, reader = _v2(A)
        reader.status.pending_demands = [{"CPU": 1}]
        scaler.run_once()
        inst = next(iter(scaler.im.instances.values()))
        reader.status.pending_demands = []
        reader.status.alive_node_ids = [inst.node_id_hex]
        scaler.run_once()
        if inst.status == A.RAY_RUNNING:
            scaler.run_once()
        return inst.status, provider.non_terminated_nodes()
    assert both(case) == (PORT.TERMINATED, [])


def test_respects_max_nodes():
    def case(A):
        scaler, provider, reader = _v2(A, max_nodes=2)
        reader.status.pending_demands = [{"CPU": 2}] * 10
        scaler.run_once()
        return len(scaler.im.active())
    assert both(case) <= 2


# ---- AutoscalerV2 over the GKE TPU provider (fake backend) --------------------

def _slice_scaler(A):
    backend = A.FakeSliceBackend()
    provider = A.GKETPUNodeProvider(accelerator_type="v5p-32",
                                    backend=backend)
    reader = _Reader(A)
    scaler = A.AutoscalerV2(
        reader, provider,
        [A.NodeType("tpu-v5p-32-slice", {"TPU-v5p-32-head": 1, "TPU": 16})],
        max_nodes=2, idle_timeout_s=60.0)
    return scaler, provider, backend, reader


def test_head_demand_materializes_four_host_slice():
    def case(A):
        scaler, provider, backend, reader = _slice_scaler(A)
        reader.status.pending_demands = [{"TPU-v5p-32-head": 1}]
        scaler.run_once()
        insts = list(scaler.im.instances.values())
        first = [i.status for i in insts]
        (pool,) = backend.hosts_by_pool
        hosts = [{k if k != pool else "<pool>": v
                  for k, v in h["resources"].items()}
                 for h in backend.hosts_by_pool[pool]]
        reader.status.pending_demands = []
        reader.status.alive_node_ids = [insts[0].node_id_hex]
        scaler.run_once()
        return first, hosts, insts[0].status, len(scaler.im.active())
    first, hosts, after, active = both(case)
    assert first == [PORT.ALLOCATED] and len(hosts) == 4
    assert [h for h in hosts if "TPU-v5p-32-head" in h] == [hosts[0]]
    assert all(h["TPU"] == 4.0 and h["<pool>"] == 1.0 for h in hosts)
    assert after == PORT.RAY_RUNNING and active == 1


def test_booting_slice_absorbs_demand_no_double_launch():
    def case(A):
        scaler, provider, backend, reader = _slice_scaler(A)
        reader.status.pending_demands = [{"TPU-v5p-32-head": 1}]
        scaler.run_once()
        once = len(backend.hosts_by_pool)
        scaler.run_once()
        return once, len(backend.hosts_by_pool)
    assert both(case) == (1, 1)


def test_terminate_deletes_the_pool():
    def case(A):
        scaler, provider, backend, reader = _slice_scaler(A)
        reader.status.pending_demands = [{"TPU-v5p-32-head": 1}]
        scaler.run_once()
        scaler.im.terminate(next(iter(scaler.im.instances.values())))
        return backend.hosts_by_pool, provider.non_terminated_nodes()
    assert both(case) == ({}, [])


def test_slice_chips_generation_table():
    def case(A):
        chips = {acc: A.GKETPUNodeProvider(
            accelerator_type=acc, backend=A.FakeSliceBackend()).slice_chips
            for acc in ("v2-8", "v3-8", "v4-8", "v5p-8", "v5p-16", "v5p-32",
                        "v5litepod-8", "v5e-4", "v6e-8", "weird")}
        p = A.GKETPUNodeProvider(accelerator_type="v5p-16",
                                 backend=A.FakeSliceBackend())
        return chips, p._host_resources("pool-x"), \
            p._topology_for(p.slice_chips)
    chips, hosts, topo = both(case)
    assert chips == {"v2-8": 4, "v3-8": 4, "v4-8": 4, "v5p-8": 4,
                     "v5p-16": 8, "v5p-32": 16, "v5litepod-8": 8,
                     "v5e-4": 4, "v6e-8": 8, "weird": 4}
    assert len(hosts) == 2 and all(h["TPU"] == 4.0 for h in hosts)
    assert "TPU-v5p-16-head" in hosts[0] and topo == "2x2x2"


# ---- tests/test_autoscaler_v2_lifecycle.py: the state machine -----------------

def _flaky(A, fail_n):
    """A fake provider of package A failing its first `fail_n`
    create_node calls."""
    class Flaky(A.FakeMultiNodeProvider):
        def __init__(self):
            super().__init__()
            self.attempts = 0

        def create_node(self, resources):
            self.attempts += 1
            if self.attempts <= fail_n:
                raise RuntimeError(f"cloud says no (attempt {self.attempts})")
            return super().create_node(resources)
    return Flaky()


def _cpu2(A):
    return A.NodeType("cpu2", {"CPU": 2})


def _events(records):
    """Lifecycle records without their node ids and clocks."""
    return [(r["from"], r["to"], r["reason"], r["node_type"])
            for r in records]


def test_happy_path_walk():
    def case(A):
        inst = A.Instance(instance_id="i1", node_type="cpu2")
        for status in (A.REQUESTED, A.ALLOCATED, A.RAY_RUNNING,
                       A.TERMINATING, A.TERMINATED):
            inst.set_status(status, reason="walk")
        return inst.status, inst.status_history, _events(inst.transitions)
    status, history, events = both(case)
    assert status == PORT.TERMINATED
    assert history == [PORT.QUEUED, PORT.REQUESTED, PORT.ALLOCATED,
                       PORT.RAY_RUNNING, PORT.TERMINATING]
    assert all(e[2] == "walk" for e in events)


def test_illegal_edges_raise():
    def case(A):
        refused = []
        for frm, to in ((A.QUEUED, A.RAY_RUNNING), (A.QUEUED, A.ALLOCATED),
                        (A.REQUESTED, A.RAY_RUNNING),
                        (A.ALLOCATED, A.REQUESTED),
                        (A.RAY_RUNNING, A.ALLOCATED),
                        (A.RAY_RUNNING, A.QUEUED),
                        (A.TERMINATING, A.RAY_RUNNING),
                        (A.TERMINATED, A.QUEUED),
                        (A.TERMINATED, A.TERMINATING), (A.QUEUED, "BOOTED")):
            inst = A.Instance(instance_id="ix", node_type="t")
            inst.status = frm
            with pytest.raises(A.InstanceLifecycleError):
                inst.set_status(to)
            refused.append((frm, to))
        return refused
    assert len(both(case)) == 10


def test_edge_table_is_exactly_the_documented_machine():
    def case(A):
        taken = set()
        for frm, allowed in A.LEGAL_TRANSITIONS.items():
            for to in A.LEGAL_TRANSITIONS:
                inst = A.Instance(instance_id="iz", node_type="t")
                inst.status = frm
                if to in allowed:
                    inst.set_status(to)
                    taken.add((frm, to))
                else:
                    with pytest.raises(A.InstanceLifecycleError):
                        inst.set_status(to)
        return {k: sorted(v) for k, v in A.LEGAL_TRANSITIONS.items()}, \
            sorted(taken)
    table, taken = both(case)
    assert len(taken) == sum(len(v) for v in table.values()) == 11


def test_provider_error_requeues_then_succeeds():
    def case(A):
        provider = _flaky(A, fail_n=2)
        events = []
        im = A.InstanceManager(provider, max_launch_retries=2,
                               on_event=events.append)
        inst = im.launch(_cpu2(A))
        trail = [(inst.status, inst.retries)]
        for _ in range(2):
            im.drive({"cpu2": _cpu2(A)})
            trail.append((inst.status, inst.retries))
        return trail, provider.attempts, _events(events)
    trail, attempts, events = both(case)
    assert trail == [(PORT.QUEUED, 1), (PORT.QUEUED, 2), (PORT.ALLOCATED, 2)]
    assert attempts == 3
    requeues = [e for e in events if e[1] == PORT.QUEUED]
    assert len(requeues) == 2 and "provider error" in requeues[0][2]


def test_retry_budget_exhausted_terminates():
    def case(A):
        provider = _flaky(A, fail_n=99)
        im = A.InstanceManager(provider, max_launch_retries=2)
        inst = im.launch(_cpu2(A))
        im.drive({"cpu2": _cpu2(A)})
        im.drive({"cpu2": _cpu2(A)})
        out = (inst.status, inst.transitions[-1]["reason"],
               provider.attempts, im.active())
        im.drive({"cpu2": _cpu2(A)})
        return out, provider.attempts
    (status, reason, attempts, active), after = both(case)
    assert status == PORT.TERMINATED and active == []
    assert "provider error after 3 attempts" in reason
    assert attempts == after == 3


def test_allocated_never_joins_requeued_on_budget():
    def case(A):
        provider = A.FakeMultiNodeProvider()
        im = A.InstanceManager(provider, max_launch_retries=2,
                               stuck_timeouts={A.ALLOCATED: 0.05})
        inst = im.launch(_cpu2(A))
        time.sleep(0.08)
        im.reconcile(alive_node_ids=[])
        queued = [i.retries for i in im.instances.values()
                  if i.status == A.QUEUED]
        return (inst.status, "stuck in ALLOCATED" in
                inst.transitions[-1]["reason"],
                provider.non_terminated_nodes(), queued)
    assert both(case) == (PORT.TERMINATED, True, [], [1])


def test_allocated_stuck_without_budget_just_terminates():
    def case(A):
        im = A.InstanceManager(A.FakeMultiNodeProvider(),
                               max_launch_retries=0,
                               stuck_timeouts={A.ALLOCATED: 0.05})
        inst = im.launch(_cpu2(A))
        time.sleep(0.08)
        im.reconcile(alive_node_ids=[])
        return inst.status, [i for i in im.instances.values()
                             if i.status == A.QUEUED]
    assert both(case) == (PORT.TERMINATED, [])


def test_terminating_stuck_forced_terminated():
    def case(A):
        im = A.InstanceManager(A.FakeMultiNodeProvider(),
                               stuck_timeouts={A.TERMINATING: 0.05})
        inst = A.Instance(instance_id="t1", node_type="cpu2")
        inst.status = A.TERMINATING
        inst.state_since = time.monotonic() - 1.0
        im.instances[inst.instance_id] = inst
        im.reconcile(alive_node_ids=[])
        return inst.status, inst.transitions[-1]["reason"].split(" for ")[0]
    assert both(case) == (PORT.TERMINATED, "stuck in TERMINATING")


def test_fresh_states_not_swept():
    def case(A):
        im = A.InstanceManager(A.FakeMultiNodeProvider(),
                               stuck_timeouts={A.ALLOCATED: 30.0})
        inst = im.launch(_cpu2(A))
        im.reconcile(alive_node_ids=[])
        return inst.status
    assert both(case) == PORT.ALLOCATED


def test_event_stream_orders_and_reasons():
    def case(A):
        events = []
        im = A.InstanceManager(A.FakeMultiNodeProvider(),
                               on_event=events.append)
        inst = im.launch(_cpu2(A))
        im.reconcile(alive_node_ids=[inst.node_id_hex])
        im.terminate(inst, reason="test done")
        return _events(events)
    events = both(case)
    assert [e[1] for e in events] == [PORT.REQUESTED, PORT.ALLOCATED,
                                      PORT.RAY_RUNNING, PORT.TERMINATING,
                                      PORT.TERMINATED]
    assert events[-1][2] == "test done"
    assert all(e[3] == "cpu2" for e in events)


def test_broken_listener_does_not_stall_scaling():
    def case(A):
        im = A.InstanceManager(A.FakeMultiNodeProvider())

        def bad(_evt):
            raise RuntimeError("listener bug")
        im.add_listener(bad)
        return im.launch(_cpu2(A)).status
    assert both(case) == PORT.ALLOCATED


def test_vanished_provider_node_terminates():
    def case(A):
        provider = A.FakeMultiNodeProvider()
        im = A.InstanceManager(provider)
        inst = im.launch(_cpu2(A))
        provider.terminate_node(inst.provider_node)
        im.reconcile(alive_node_ids=[])
        return inst.status, inst.transitions[-1]["reason"]
    assert both(case) == (PORT.TERMINATED, "provider node vanished")


def test_status_reader_nm_outage_transient_vs_sustained():
    """A transient node-manager failure keeps a node alive and busy; the
    third failure in a row drops it; recovery resets the streak."""
    nid = b"\x01" * 8

    def case(A):
        nm_down = [True]

        class Gcs:
            def call(self, method, **kw):
                if method == "get_all_nodes":
                    return [SimpleNamespace(alive=True, node_id=nid,
                                            address=("127.0.0.1", 1))]
                return []

        class NM:
            def call(self, method, **kw):
                if nm_down[0]:
                    raise OSError("nm unreachable")
                if method == "nm_get_info":
                    return {"available": {"CPU": 2},
                            "pending_resource_shapes": []}
                return []

        class Pool:
            def get(self, addr):
                return NM()

        reader = A.ClusterStatusReader.__new__(A.ClusterStatusReader)
        reader._gcs, reader._pool = Gcs(), Pool()
        reader.nm_unreachable_rounds = 3
        reader._nm_fail_rounds = {}
        views = []
        for down in (True, True, True, False, True):
            nm_down[0] = down
            st = reader.read()
            views.append((st.alive_node_ids, st.busy_node_ids,
                          st.node_available, st.pending_demands))
        return views
    h = nid.hex()
    assert both(case) == [([h], [h], [], []), ([h], [h], [], []),
                          ([], [], [], []), ([h], [], [{"CPU": 2}], []),
                          ([h], [h], [], [])]


def test_scale_up_then_down_full_lifecycle():
    def case(A):
        provider = A.FakeMultiNodeProvider()
        reader = _Reader(A)
        scaler = A.AutoscalerV2(reader, provider, [_cpu2(A)], max_nodes=4,
                                idle_timeout_s=0.0)
        events = []
        scaler.im.add_listener(events.append)
        reader.status.pending_demands = [{"CPU": 1}, {"CPU": 1}]
        scaler.run_once()
        insts = list(scaler.im.instances.values())
        first = [i.status for i in insts]
        reader.status.pending_demands = []
        reader.status.alive_node_ids = [insts[0].node_id_hex]
        scaler.run_once()
        scaler.run_once()
        return first, insts[0].status, provider.non_terminated_nodes(), \
            _events(events)
    first, status, nodes, events = both(case)
    assert first == [PORT.ALLOCATED] and status == PORT.TERMINATED
    assert nodes == []
    assert [e[1] for e in events] == [PORT.REQUESTED, PORT.ALLOCATED,
                                      PORT.RAY_RUNNING, PORT.TERMINATING,
                                      PORT.TERMINATED]
    assert "idle" in events[-1][2]


def test_flaky_provider_retries_across_passes():
    def case(A):
        reader = _Reader(A)
        scaler = A.AutoscalerV2(reader, _flaky(A, fail_n=1),
                                [_cpu2(A)], max_nodes=4, idle_timeout_s=60.0)
        reader.status.pending_demands = [{"CPU": 1}]
        scaler.run_once()
        insts = list(scaler.im.instances.values())
        first = [i.status for i in insts]
        scaler.run_once()
        return first, insts[0].status, len(scaler.im.instances)
    assert both(case) == ([PORT.QUEUED], PORT.ALLOCATED, 1)


def test_provider_node_dataclass_roundtrip():
    def case(A):
        im = A.InstanceManager(A.FakeMultiNodeProvider())
        inst = im.launch(_cpu2(A))
        snap = im.snapshot()[0]
        assert snap["instance_id"] == inst.instance_id
        assert isinstance(A.ProviderNode("p1"), A.ProviderNode)
        return snap["status"], snap["status_history"], sorted(snap)
    status, history, keys = both(case)
    assert status == PORT.ALLOCATED
    assert history == [PORT.QUEUED, PORT.REQUESTED]


# ---- tests/test_gke_provider.py: gcloud's arguments ---------------------------

def _gke(A, acc="v5p-8"):
    p = A.GKETPUNodeProvider(cluster="c1", zone="us-east5-a",
                             accelerator_type=acc)
    assert isinstance(p.backend, A.GKESliceBackend)
    calls = []
    p.backend._run = lambda args: calls.append(list(args)) or ""
    return p, calls


def _unpooled(calls, pool):
    return [[a.replace(pool, "<pool>") for a in c] for c in calls]


def test_create_node_emits_exact_gcloud_create_args():
    def case(A):
        p, calls = _gke(A)
        pool = p.create_node({"TPU": 4.0}).provider_id
        assert pool.startswith("ray-tpu-") and len(pool) == 14
        return _unpooled(calls, pool)
    assert both(case) == [[
        "container", "node-pools", "create", "<pool>", "--cluster=c1",
        "--zone=us-east5-a", "--num-nodes=1",
        "--machine-type=ct5p-hightpu-4t", "--tpu-topology=2x2x1"]]


def test_terminate_node_emits_exact_gcloud_delete_args():
    def case(A):
        p, calls = _gke(A)
        node = p.create_node({"TPU": 4.0})
        calls.clear()
        p.terminate_node(node)
        return _unpooled(calls, node.provider_id), p.non_terminated_nodes()
    assert both(case) == ([[
        "container", "node-pools", "delete", "<pool>", "--cluster=c1",
        "--zone=us-east5-a", "--quiet"]], [])


@pytest.mark.parametrize("acc,num_nodes,topology", [
    ("v5p-8", 1, "2x2x1"), ("v5p-16", 2, "2x2x2"), ("v5p-32", 4, "2x2x4"),
    ("v5p-64", 8, "2x4x4"), ("v5p-128", 16, "4x4x4")])
def test_topology_and_num_nodes_derive_from_one_chip_count(
        acc, num_nodes, topology):
    def case(A):
        p, calls = _gke(A, acc)
        pool = p.create_node({}).provider_id
        return _unpooled(calls, pool)
    (call,) = both(case)
    assert f"--num-nodes={num_nodes}" in call
    assert f"--tpu-topology={topology}" in call


def test_unsupported_slice_size_rejected_before_gcloud():
    def case(A):
        p, calls = _gke(A, "v5p-384")
        with pytest.raises(ValueError, match="unsupported v5p slice size"):
            p.create_node({})
        return calls
    assert both(case) == []


def test_topology_map_is_exact():
    def case(A):
        f = A.GKETPUNodeProvider._topology_for
        with pytest.raises(ValueError):
            f(12)
        return [f(c) for c in (4, 8, 16, 32, 64)]
    assert both(case) == ["2x2x1", "2x2x2", "2x2x4", "2x4x4", "4x4x4"]


def test_slice_chips_honors_cores_per_chip():
    def case(A):
        return [_gke(A, acc)[0].slice_chips
                for acc in ("v5p-16", "v5e-16", "bogus")]
    assert both(case) == [8, 16, 4]


def test_head_resource_lands_exactly_once_per_slice():
    def case(A):
        return _gke(A, "v5p-32")[0]._host_resources("pool-x")
    hosts = both(case)
    assert len(hosts) == 4
    assert all(h["TPU"] == 4.0 and h["pool-x"] == 1.0 for h in hosts)
    assert [h for h in hosts if "TPU-v5p-32-head" in h] == [hosts[0]]


def test_create_node_registers_hosts_with_pool_resources():
    def case(A):
        p, _ = _gke(A, "v5p-16")
        node = p.create_node({})
        hosts = node.handle["hosts"]
        assert p.non_terminated_nodes() == [node]
        return [(h["host_id"].replace(node.provider_id, "<pool>"),
                 h["resources"][node.provider_id]) for h in hosts]
    assert both(case) == [("<pool>-host0", 1.0), ("<pool>-host1", 1.0)]


# ---- on the port's cluster ------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=1)  # a tiny head: parallel work queues
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_report_and_state_surface(cluster):
    """AutoscalerV2 with gcs_address reports its instance table and
    lifecycle events to the port's GCS: util.state.autoscaler_instances,
    the cluster event log and the "autoscaler_lifecycle" channel."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util import state as state_api

    got = []
    cw = worker_mod.global_worker().core_worker
    token = cw.subscribe("autoscaler_lifecycle", got.append)
    try:
        reader = _Reader(PORT)
        scaler = PORT.AutoscalerV2(
            reader, PORT.FakeMultiNodeProvider(), [_cpu2(PORT)],
            max_nodes=2, idle_timeout_s=60.0,
            gcs_address=ray_tpu_torch.get_gcs_address())
        reader.status.pending_demands = [{"CPU": 1}]
        scaler.run_once()
        out = state_api.autoscaler_instances()
        assert [i["status"] for i in out["instances"]] == [PORT.ALLOCATED]
        assert [e["to"] for e in out["events"]][-2:] == [PORT.REQUESTED,
                                                         PORT.ALLOCATED]
        assert len(cw._gcs.call("list_events",
                                event_type="AUTOSCALER_INSTANCE")) >= 2
        deadline = time.monotonic() + 10
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert [e["to"] for e in got[:2]] == [PORT.REQUESTED, PORT.ALLOCATED]
    finally:
        cw.unsubscribe("autoscaler_lifecycle", token)


def test_status_reader_sees_pending_pg_demand(cluster):
    """A PENDING placement group's bundles surface as scheduler demand
    (the elastic replacement probe rides this)."""
    from ray_tpu_torch.util import placement_group, remove_placement_group

    pg = placement_group([{"elastic_probe_res": 1.0}], strategy="PACK")
    try:
        reader = PORT.ClusterStatusReader(ray_tpu_torch.get_gcs_address())
        deadline = time.monotonic() + 10
        demands = []
        while time.monotonic() < deadline:
            demands = reader.read().pending_demands
            if any("elastic_probe_res" in d for d in demands):
                break
            time.sleep(0.1)
        assert any("elastic_probe_res" in d for d in demands), demands
    finally:
        remove_placement_group(pg)


def test_memory_monitor_kills_newest_retriable_task(cluster, tmp_path):
    """tests/test_ops_tooling.py's memory-monitor case on the port: forced
    memory pressure kills the running retriable task's worker, the owner
    retries it and the node survives."""
    import os

    from ray_tpu_torch._private import worker as worker_mod
    marker = str(tmp_path / "oom_marker")

    @ray_tpu_torch.remote(max_retries=2)
    def hog(path):
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write("1")
            time.sleep(30)  # killed mid-run by the monitor
            return "survived?"
        return "retried"

    nm = worker_mod.global_worker().node.node_manager
    ref = hog.remote(marker)
    deadline = time.time() + 30
    while time.time() < deadline and not os.path.exists(marker):
        time.sleep(0.1)
    assert os.path.exists(marker)
    os.environ["RAY_TPU_testing_fake_memory_usage"] = "0.99"
    try:
        assert ray_tpu_torch.get(ref, timeout=90) == "retried"
        assert nm.memory_monitor.num_kills >= 1
    finally:
        os.environ.pop("RAY_TPU_testing_fake_memory_usage", None)


def test_autoscaler_scales_up_and_down(cluster):
    """tests/test_ops_tooling.py's real-node case on the port: queued
    leases launch node_main processes through LocalNodeProvider, and
    idleness (5 s) reclaims them."""
    gcs = ray_tpu_torch.get_gcs_address()
    provider = PORT.LocalNodeProvider(gcs)
    scaler = PORT.StandardAutoscaler(
        gcs, provider, resources_per_node={"CPU": 2.0}, min_workers=0,
        max_workers=2, idle_timeout_s=5.0, poll_period_s=1.0)
    scaler.start()
    try:
        @ray_tpu_torch.remote
        def slow(i):
            time.sleep(3)
            return i

        refs = [slow.remote(i) for i in range(6)]
        assert sorted(ray_tpu_torch.get(refs, timeout=120)) == list(range(6))
        assert scaler.num_scale_ups >= 1, "autoscaler never scaled up"
        assert len(ray_tpu_torch.nodes()) >= 2
        deadline = time.time() + 60
        while time.time() < deadline and provider.non_terminated_nodes():
            time.sleep(0.5)
        assert not provider.non_terminated_nodes(), \
            "idle nodes never reclaimed"
        assert scaler.num_scale_downs >= 1
    finally:
        scaler.stop()
        for node in provider.non_terminated_nodes():
            provider.terminate_node(node)
