"""The port's dashboard (dashboard/head.py and dashboard/metrics.py,
copies of the JAX package's under the rename rule) on the CPU: its JSON
endpoints, live stack profiling, the metrics configs and the overview
page, and the replay plane's /api/replay.

Mirrors of tests/test_dashboard.py's four cases on ray_tpu_torch, and a
case of /api/replay over a two-shard ReplayGroup. One cluster for the
module (ray_tpu_torch.init(num_cpus=4)).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.dashboard import start_dashboard
from ray_tpu_torch.util import state as state_api


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _get(port, route):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{route}", timeout=30) as r:
        return json.loads(r.read())


def test_dashboard_endpoints():
    @ray_tpu_torch.remote
    def traced():
        return 1

    @ray_tpu_torch.remote
    class Dummy:
        def ping(self):
            return "pong"

    a = Dummy.options(num_cpus=0.1).remote()
    ray_tpu_torch.get([traced.remote(), a.ping.remote()])
    time.sleep(1.5)  # task event flush

    dash = start_dashboard(port=0)
    port = ray_tpu_torch.get(dash.ready.remote())
    try:
        cluster = _get(port, "/api/cluster")
        assert cluster["resources_total"].get("CPU", 0) > 0
        assert len(cluster["nodes"]) >= 1

        tasks = _get(port, "/api/tasks")
        assert any(t.get("name") == "traced" for t in tasks)
        finished = _get(port, "/api/tasks?state=FINISHED")
        assert finished and all(t["state"] == "FINISHED" for t in finished)

        actors = _get(port, "/api/actors")
        assert any(x["class_name"] == "Dummy" for x in actors)

        summary = _get(port, "/api/summary")
        assert summary.get("FINISHED", 0) >= 1

        objects = _get(port, "/api/objects")
        assert "store_stats" in objects

        locks = _get(port, "/api/locks")
        assert any(a["name"] == "core_worker"
                   for s in locks["procs"]
                   for a in s.get("locks", ()))

        # serve request telemetry answers with the query plane's shape
        # even with no proxies running
        reqs = _get(port, "/api/serve/requests?errors=1")
        assert "requests" in reqs and "proxies" in reqs \
            and "unreachable" in reqs

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=30) as r:
            assert b"ray_tpu dashboard" in r.read()

        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/api/nope")
        assert e.value.code == 404
    finally:
        ray_tpu_torch.get(dash.stop.remote())
        ray_tpu_torch.kill(a)
        ray_tpu_torch.kill(dash)


def test_live_stack_profiling():
    """A busy worker's live stack dump shows the executing frame."""
    @ray_tpu_torch.remote
    def spin_marker_fn():
        t0 = time.time()
        while time.time() - t0 < 6:
            time.sleep(0.05)
        return 1

    ref = spin_marker_fn.remote()
    deadline = time.time() + 60
    busy = None
    while time.time() < deadline and busy is None:
        for w in state_api.list_workers():
            if w.get("current_task") == "spin_marker_fn":
                busy = w
                break
        time.sleep(0.2)
    assert busy is not None, "task never started"
    dump = state_api.profile_worker_stack(busy["worker_id"])
    assert dump["pid"] == busy["pid"]
    assert "spin_marker_fn" in dump["stack"], dump["stack"][-1500:]
    assert ray_tpu_torch.get(ref, timeout=120) == 1


def test_metrics_configs_written(tmp_path):
    from ray_tpu_torch.dashboard.metrics import write_metrics_configs
    paths = write_metrics_configs(out_dir=str(tmp_path))
    with open(paths["grafana_dashboard"]) as f:
        dash = json.load(f)
    assert dash["panels"] and dash["title"]
    prom = open(paths["prometheus"]).read()
    assert "scrape_configs" in prom and "/metrics" in prom


def test_overview_page_renders_live_actor():
    """The server-rendered page shows the cluster, nodes, actors, jobs
    and events tables and a timeline link, and lists a live actor by
    class name; the timeline endpoint serves a download."""
    @ray_tpu_torch.remote
    class PageProbeActor:
        def ping(self):
            return "pong"

    a = PageProbeActor.options(num_cpus=0.1).remote()
    ray_tpu_torch.get(a.ping.remote())
    dash = start_dashboard(port=0)
    port = ray_tpu_torch.get(dash.ready.remote())
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=30) as r:
            page = r.read().decode()
        for table in ("cluster", "nodes", "actors", "jobs", "recent events"):
            assert f"<h2>{table}</h2>" in page
        assert "/api/timeline" in page
        assert "PageProbeActor" in page
        req = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/timeline", timeout=30)
        assert "attachment" in req.headers.get("Content-Disposition", "")
        assert isinstance(json.loads(req.read()), list)
    finally:
        ray_tpu_torch.get(dash.stop.remote(), timeout=30)
        ray_tpu_torch.kill(dash)
        ray_tpu_torch.kill(a)


def test_replay_route_lists_the_shards():
    """/api/replay: each live shard of a two-shard ReplayGroup with its
    occupancy, as util.state.replay_shards() gives it."""
    from ray_tpu_torch.dashboard.head import DashboardHead
    from ray_tpu_torch.rllib.utils.replay import ReplayGroup
    group = ReplayGroup(2, 100, prioritized=True, batch_size=4, seed=0,
                        name="dash_replay", shard_num_cpus=0.1)
    head = DashboardHead(port=0)
    try:
        handles = dict(group.shard_handles())
        assert ray_tpu_torch.get([h.ping.remote() for h in handles.values()],
                                 timeout=120) == ["pong", "pong"]
        ray_tpu_torch.get(handles[0].push.remote(
            {"obs": np.arange(5, dtype=np.float32)}), timeout=60)
        view = _get(head.port, "/api/replay")
        mine = [s for s in view["shards"]
                if (s["stats"] or {}).get("group") == "dash_replay"]
        assert len(mine) == 2 and all(s["state"] == "ALIVE" for s in mine)
        assert sorted(s["stats"]["size"] for s in mine) == [0, 5]
        assert view["num_alive"] >= 2 and view["total_added"] >= 5
    finally:
        head.stop()
        group.stop()
