"""The port's Serve (serve/, a copy of the JAX package's under the rename
rule) on the CPU: deployments, replicas, recovery, redeploys, the HTTP
proxy, autoscaling and composition.

Mirrors of the first seven cases of tests/test_serve.py on
ray_tpu_torch, with their assertions; the rest of that file and
tests/test_serve_grpc.py are mirrored in test_torch_serve_routing.py.
One cluster for the module (ray_tpu_torch.init(num_cpus=4)), Serve shut
down after each case.
"""

import json
import os
import signal
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture()
def serve_session(cluster):
    yield cluster
    serve.shutdown()


def test_function_deployment_roundtrip(serve_session):
    @serve.deployment
    def doubler(x):
        return x * 2

    handle = serve.run(doubler)
    assert ray_tpu_torch.get(handle.remote(21)) == 42
    assert ray_tpu_torch.get(handle.remote("ab")) == "abab"


def test_class_deployment_with_state_and_replicas(serve_session):
    @serve.deployment(num_replicas=2)
    class Greeter:
        def __init__(self, greeting):
            self.greeting = greeting
            self.pid = os.getpid()

        def __call__(self, name):
            return f"{self.greeting} {name} from {self.pid}"

    handle = serve.run(Greeter.bind("hello"))
    # both replicas serve traffic (power-of-two routing spreads load);
    # sequential tie-break is random, so issue batches until both appear
    pids = set()
    deadline = time.time() + 30
    while len(pids) < 2 and time.time() < deadline:
        outs = ray_tpu_torch.get([handle.remote(f"u{i}") for i in range(8)])
        assert all(o.startswith("hello u") for o in outs)
        pids |= {o.rsplit(" ", 1)[1] for o in outs}
    assert len(pids) == 2, f"expected both replicas used, saw {pids}"


def test_replica_recovery_after_kill(serve_session):
    @serve.deployment(num_replicas=1)
    class Pid:
        def __call__(self):
            return os.getpid()

    handle = serve.run(Pid.bind(), name="pid_app")
    pid = ray_tpu_torch.get(handle.remote())
    os.kill(pid, signal.SIGKILL)
    # the controller's reconcile loop replaces the dead replica
    deadline = time.time() + 60
    new_pid = None
    while time.time() < deadline:
        try:
            handle = serve.get_handle("pid_app")
            new_pid = ray_tpu_torch.get(handle.remote(), timeout=10)
            if new_pid != pid:
                break
        except Exception:  # noqa: BLE001 - window while replica restarts
            time.sleep(0.5)
    assert new_pid is not None and new_pid != pid


def test_redeploy_replaces_code(serve_session):
    @serve.deployment(name="versioned")
    def v1():
        return "v1"

    handle = serve.run(v1)
    assert ray_tpu_torch.get(handle.remote()) == "v1"

    @serve.deployment(name="versioned")
    def v2():
        return "v2"

    handle = serve.run(v2)
    deadline = time.time() + 30
    while time.time() < deadline:
        if ray_tpu_torch.get(handle.remote()) == "v2":
            break
        time.sleep(0.2)
    assert ray_tpu_torch.get(handle.remote()) == "v2"


def test_http_proxy(serve_session):
    @serve.deployment(name="adder")
    def adder(a, b):
        return a + b

    serve.run(adder)
    proxy = serve.start_http(port=0)
    port = ray_tpu_torch.get(proxy.ready.remote())
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/adder",
        data=json.dumps({"a": 2, "b": 40}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        body = json.loads(resp.read())
    assert body == {"result": 42}
    ray_tpu_torch.get(proxy.stop.remote())
    ray_tpu_torch.kill(proxy)


def test_autoscaling_scales_up_under_load(serve_session):
    @serve.deployment(name="slow", num_replicas=1,
                      autoscaling_config=serve.api.AutoscalingConfig(
                          min_replicas=1, max_replicas=3,
                          target_ongoing_requests=1.0,
                          upscale_delay_s=0.5))
    def slow(x):
        time.sleep(0.4)
        return x

    handle = serve.run(slow)
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
    # sustained concurrent load → queue depth > target → scale up
    refs = []
    deadline = time.time() + 60
    scaled = False
    while time.time() < deadline and not scaled:
        refs.extend(handle.remote(i) for i in range(6))
        time.sleep(0.3)
        info = ray_tpu_torch.get(controller.list_deployments.remote())
        scaled = info["slow"]["target_replicas"] > 1
    assert scaled, "autoscaler never scaled up under sustained load"
    ray_tpu_torch.get(refs, timeout=120)


def test_deployment_composition(serve_session):
    """Deployments calling deployments through handles (reference serve
    app graphs): handles pickle into replicas and reconnect there."""

    @serve.deployment(name="embedder")
    def embedder(text):
        return len(text)

    @serve.deployment(name="ranker")
    class Ranker:
        def __init__(self, downstream):
            self.downstream = downstream  # DeploymentHandle

        def __call__(self, texts):
            refs = [self.downstream.remote(t) for t in texts]
            return sorted(ray_tpu_torch.get(refs), reverse=True)

    emb_handle = serve.run(embedder)
    ranker_handle = serve.run(Ranker.bind(emb_handle))
    out = ray_tpu_torch.get(ranker_handle.remote(["aa", "bbbb", "c"]))
    assert out == [4, 2, 1]
