"""The port's CLI over the cluster's planes, on the CPU: `logs`,
`metrics` and `top`, `chaos` (with the dashboard's /api/chaos),
`profile`, `memory` and `stack`, `serve requests` and `serve fleet`
against a running deployment, and `replay` against a two-shard
ReplayGroup, each called in process through scripts.cli.main (a copy of
the JAX package's under the rename rule).

Mirrors of tests/test_log_plane.py's test_cli_logs_query_and_postmortem_
listing, tests/test_metrics_plane.py's test_cli_metrics_dump_and_top,
tests/test_chaos.py's test_rule_lifecycle_counters_cli_and_dashboard and
tests/test_profiler.py's test_cli_profile_and_memory on ray_tpu_torch.
One cluster for the module (ray_tpu_torch.init(num_cpus=4)).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import chaos
from ray_tpu_torch.scripts.cli import main as cli_main
from ray_tpu_torch.util import state as state_api


@pytest.fixture(scope="module")
def address():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch.get_gcs_address()
    ray_tpu_torch.shutdown()


def _gcs_call():
    from ray_tpu_torch._private import worker as worker_mod
    return worker_mod.global_worker().core_worker._gcs.call


def _fired(rule_id):
    for r in chaos.list_rules():
        if r["rule_id"] == rule_id:
            return r["fired"]
    return 0


def test_cli_logs_query_and_postmortem_listing(address, capsys):
    @ray_tpu_torch.remote
    def clitalk():
        print("cli surface CLIMARK")
        return 1

    assert ray_tpu_torch.get(clitalk.remote(), timeout=120) == 1
    out = ""
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and "CLIMARK" not in out:
        assert cli_main(["logs", "--address", address, "--match", "CLIMARK",
                         "--format", "json"]) == 0
        out = capsys.readouterr().out
        time.sleep(0.2)
    payload = json.loads(out)
    assert any("CLIMARK" in r["msg"] for r in payload["records"])
    # text mode renders id-prefixed lines
    assert cli_main(["logs", "--address", address, "--match", "CLIMARK"]) == 0
    text = capsys.readouterr().out
    assert "CLIMARK" in text and "w:" in text and "t:" in text
    assert cli_main(["logs", "--address", address, "--postmortems"]) == 0


def test_cli_metrics_dump_and_top(address, capsys):
    assert cli_main(["metrics", "dump", "--address", address]) == 0
    out = capsys.readouterr().out
    assert "# TYPE" in out and "ray_tpu_alive_nodes" in out
    assert cli_main(["metrics", "dump", "--address", address,
                     "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["procs"] and "series" in payload and payload["merged"]
    assert cli_main(["top", "--address", address, "--iterations", "1"]) == 0
    out = capsys.readouterr().out
    assert "ray_tpu top" in out or "no samples yet" in out
    assert cli_main(["metrics", "alerts", "--address", address,
                     "--format", "json"]) == 0
    json.loads(capsys.readouterr().out)


def test_chaos_rule_in_the_cli_and_the_dashboard(address, capsys):
    """A seeded one-shot delay fires on the second matching call; `chaos
    list` and /api/chaos show it fired once and retired; clear removes
    it."""
    chaos.clear()
    rid = chaos.inject("delay", method="kv_exists", delay_ms=150,
                       after_n=1, max_fires=1, seed=3)
    try:
        call = _gcs_call()
        t0 = time.time()
        call("kv_exists", key="chaos-probe")
        first = time.time() - t0
        t0 = time.time()
        call("kv_exists", key="chaos-probe")
        second = time.time() - t0
        assert first < 0.1 <= second, (first, second)
        deadline = time.time() + 10
        while _fired(rid) < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert _fired(rid) == 1
        events = state_api.list_cluster_events(
            event_type="CHAOS_FAULT_INJECTED")
        assert any(e.get("rule_id") == rid for e in events)

        assert cli_main(["chaos", "list", "--format", "json",
                         "--address", address]) == 0
        rows = json.loads(capsys.readouterr().out)
        mine = [r for r in rows if r["rule_id"] == rid]
        assert mine and mine[0]["fired"] == 1 and mine[0]["disabled"]

        from ray_tpu_torch.dashboard.head import DashboardHead
        dash = DashboardHead(port=0)
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{dash.port}/api/chaos",
                    timeout=30) as r:
                payload = json.loads(r.read())
        finally:
            dash.stop()
        mine = [r for r in payload["rules"] if r["rule_id"] == rid]
        assert mine and mine[0]["fired"] == 1
        assert cli_main(["chaos", "clear", rid, "--address", address]) == 0
        assert "cleared 1 rule(s)" in capsys.readouterr().out
        assert all(r["rule_id"] != rid for r in chaos.list_rules())
    finally:
        chaos.clear()


def test_cli_profile_memory_and_stack(address, capsys, tmp_path):
    @ray_tpu_torch.remote
    def touch():
        return 1

    # at least one live worker for the batched stack dump below
    assert ray_tpu_torch.get(touch.remote(), timeout=120) == 1
    out_path = str(tmp_path / "prof.json")
    assert cli_main(["profile", "--address", address, "--duration", "0.5",
                     "--hz", "50", "-o", out_path]) == 0
    assert "speedscope" in capsys.readouterr().out
    ss = json.loads(open(out_path).read())
    assert ss["profiles"] and ss["shared"]["frames"]
    assert cli_main(["memory", "--address", address]) == 0
    assert "== top" in capsys.readouterr().out
    assert cli_main(["memory", "--address", address, "--group-by", "owner",
                     "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert "groups" in payload and "store_stats" in payload
    assert cli_main(["stack", "--address", address]) == 0
    assert "== worker" in capsys.readouterr().out


def test_cli_serve_requests_and_fleet(address, capsys):
    """`serve requests` (text and json, --errors, --slowest) and `serve
    fleet` against a deployment behind the ingress fleet."""
    from ray_tpu_torch import serve

    @serve.deployment(name="cli_echo")
    def echo(x=0):
        if x < 0:
            raise ValueError("negative")
        return x

    serve.run(echo)
    try:
        st = serve.start_fleet(http_port=0)
        port = st["proxies"][0]["http_port"]
        for x in (1, 2, -1):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/cli_echo",
                data=json.dumps({"x": x}).encode(),
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=60).read()
            except urllib.error.HTTPError as e:
                assert e.code == 500
        assert cli_main(["serve", "requests", "--address", address,
                         "--errors", "--format", "json"]) == 0
        errs = json.loads(capsys.readouterr().out)["requests"]
        assert any(e["deployment"] == "cli_echo" and e["code"] == 500
                   for e in errs)
        assert cli_main(["serve", "requests", "--address", address,
                         "--slowest", "3"]) == 0
        text = capsys.readouterr().out
        assert "cli_echo" in text and "answered" in text
        assert cli_main(["serve", "fleet", "--address", address]) == 0
        text = capsys.readouterr().out
        assert "ingress fleet: enabled=True" in text and "healthy" in text
        assert cli_main(["serve", "fleet", "--address", address,
                         "--format", "json"]) == 0
        fleet = json.loads(capsys.readouterr().out)
        assert fleet["enabled"] and fleet["proxies"]
    finally:
        serve.shutdown()


def test_cli_replay_lists_two_shards(address, capsys):
    from ray_tpu_torch.rllib.utils.replay import ReplayGroup
    group = ReplayGroup(2, 100, prioritized=True, batch_size=4, seed=0,
                        name="cli_replay", shard_num_cpus=0.1)
    try:
        handles = dict(group.shard_handles())
        assert ray_tpu_torch.get([h.ping.remote() for h in handles.values()],
                                 timeout=120) == ["pong", "pong"]
        ray_tpu_torch.get(handles[1].push.remote(
            {"obs": np.arange(7, dtype=np.float32)}), timeout=60)
        assert cli_main(["replay", "--address", address, "--format",
                         "json"]) == 0
        view = json.loads(capsys.readouterr().out)
        mine = [s for s in view["shards"]
                if (s["stats"] or {}).get("group") == "cli_replay"]
        assert sorted(s["stats"]["size"] for s in mine) == [0, 7]
        assert cli_main(["replay", "--address", address]) == 0
        text = capsys.readouterr().out
        assert "replay shards:" in text and text.count("ALIVE") >= 2
    finally:
        group.stop()
