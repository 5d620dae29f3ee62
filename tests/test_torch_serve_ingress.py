"""The port's Serve ingress fleet (serve/_private/proxy_fleet/, copies of
the JAX package's under the rename rule) on the CPU: one proxy actor
serving HTTP and gRPC, its replacement after a kill, drain, and one
proxy a node as nodes join and die.

Mirrors of tests/test_proxy_fleet.py's functional cases on
ray_tpu_torch, with their assertions (its admission cases are in
test_torch_serve_telemetry.py). Left out: the zero-failure rolling
update under chaos, the shed-burn watchdog and the 10x brownout sweep,
whose bars are timings of a loaded box (CHANGES.md). One cluster for the
module (ray_tpu_torch.init(num_cpus=4)); the node join/death case, last,
shuts it down and starts a two-node Cluster of its own.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.util import state as state_api


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture()
def serve_session(cluster):
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=4)
    yield cluster
    serve.shutdown()


def _post(port, dep, body=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{dep}",
        data=json.dumps(body if body is not None else {}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def test_fleet_serves_http_and_grpc_from_one_actor(serve_session):
    """One AsyncProxyActor per node carries BOTH transports off one
    event loop; the fleet status + state API surface it."""

    @serve.deployment(name="fleet_echo")
    def echo(x=0, scale=1):
        return x * scale

    serve.run(echo)
    st = serve.start_fleet(http_port=0, grpc_port=0)
    assert len(st["proxies"]) == 1
    p = st["proxies"][0]
    assert p["http_port"] and p["grpc_port"] and p["healthy"]
    body, headers = _post(p["http_port"], "fleet_echo",
                          {"x": 21, "scale": 2})
    assert body == {"result": 42}
    assert headers.get("X-Request-Id")
    assert serve.grpc_call(f"127.0.0.1:{p['grpc_port']}",
                           "fleet_echo", 21, scale=2) == 42
    # state API enrichment: admission snapshot rides along
    fleet = state_api.serve_fleet()
    assert fleet["enabled"] and fleet["proxies"][0]["admission"] \
        is not None


def test_fleet_replaces_killed_proxy_chaos(serve_session):
    """The chaos plane's proxy-kill rule: the fleet health checks detect
    the dead proxy and reconcile a replacement; traffic recovers."""
    from ray_tpu_torch import chaos

    @serve.deployment(name="fleet_kill")
    def f(x=0):
        return x + 1

    serve.run(f)
    proxy = serve.start_http(port=0)
    port = ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    assert _post(port, "fleet_kill", {"x": 1})[0] == {"result": 2}
    rid = chaos.inject("kill_worker", actor_class="AsyncProxyActor",
                       max_fires=1)
    try:
        # the next actor call to the proxy fires the kill
        try:
            ray_tpu_torch.get(proxy.ping.remote(), timeout=30)
        except Exception:  # noqa: BLE001 - died under the call, expected
            pass
        # fleet reconcile replaces it (dead proxies replace immediately)
        deadline = time.monotonic() + 60
        new_port = None
        while time.monotonic() < deadline:
            st = serve.fleet_status()
            ps = st.get("proxies", [])
            if ps and ps[0]["healthy"]:
                new_port = ps[0]["http_port"]
                try:
                    if _post(new_port, "fleet_kill",
                             {"x": 2})[0] == {"result": 3}:
                        break
                except Exception:  # noqa: BLE001 - still coming up
                    pass
            time.sleep(0.5)
        else:
            pytest.fail(f"fleet never replaced killed proxy: "
                        f"{serve.fleet_status()}")
    finally:
        chaos.clear([rid])


def test_drain_completes_inflight_then_refuses(serve_session):
    """Drain lifecycle: in-flight requests finish (no 5xx), the
    listener closes (new connections refused), the fleet deregisters
    the proxy."""

    @serve.deployment(name="fleet_slow", num_replicas=2)
    def slow(x=0):
        time.sleep(0.4)
        return x

    serve.run(slow)
    proxy = serve.start_http(port=0)
    port = ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    _post(port, "fleet_slow")  # warm
    results = []

    def call(i):
        try:
            results.append(("ok", _post(port, "fleet_slow",
                                        {"x": i})[0]["result"]))
        except Exception as e:  # noqa: BLE001
            results.append(("err", repr(e)))

    ts = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    time.sleep(0.15)  # requests in flight on the replicas
    node = ray_tpu_torch.get_runtime_context().get_node_id()
    assert serve.drain_proxy(node) is True
    for t in ts:
        t.join(timeout=60)
    # every in-flight request finished with a result, none got 5xx
    assert [r for r in results if r[0] == "err"] == [], results
    assert sorted(r[1] for r in results) == [0, 1, 2, 3]
    # the listener is closed now: a fresh connection is refused
    with pytest.raises((ConnectionError, urllib.error.URLError,
                        socket.timeout, OSError)):
        _post(port, "fleet_slow", timeout=5)
    # and the fleet shows no proxy for the node (cordoned, no respawn)
    time.sleep(1.5)
    assert serve.fleet_status()["proxies"] == []


def test_fleet_covers_node_join_and_death():
    """One proxy per alive node: a joining node gets a proxy within a
    reconcile round; a dead node's proxy deregisters."""
    from ray_tpu_torch.cluster_utils import Cluster
    ray_tpu_torch.shutdown()  # release the session-scoped local cluster
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        c.connect()

        @serve.deployment(name="fleet_multi")
        def f(x=0):
            return x

        serve.run(f)
        serve.start_http(port=0)
        assert len(serve.fleet_status()["proxies"]) == 1
        n2 = c.add_node(num_cpus=2)
        c.wait_for_nodes()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            ps = serve.fleet_status()["proxies"]
            if len(ps) == 2 and all(p["healthy"] for p in ps):
                break
            time.sleep(0.5)
        else:
            pytest.fail(f"no proxy for joined node: "
                        f"{serve.fleet_status()}")
        # every proxy serves traffic
        for p in serve.fleet_status()["proxies"]:
            assert _post(p["http_port"], "fleet_multi",
                         {"x": 7})[0] == {"result": 7}
        c.remove_node(n2, allow_graceful=True)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if len(serve.fleet_status()["proxies"]) == 1:
                break
            time.sleep(0.5)
        else:
            pytest.fail(f"dead node's proxy never deregistered: "
                        f"{serve.fleet_status()}")
        serve.shutdown()
    finally:
        c.shutdown()
