"""The port's Serve request telemetry and admission (serve/_telemetry.py,
the proxies and proxy_fleet/admission.py, copies of the JAX package's
under the rename rule) on the CPU: RED metrics and queue gauges on the
merged exposition, the proxies' error semantics and request ring, the
gRPC ingress's trace metadata, shedding with Retry-After and rate
limiting.

Mirrors of tests/test_serve_telemetry.py's functional cases on
ray_tpu_torch, with their assertions and their `ray_tpu serve requests`
CLI calls (scripts.cli.main), and of tests/test_proxy_fleet.py's two
admission cases. Left out: the trace through
nested replicas into the merged timeline, the SLO watchdog under chaos
and the telemetry overhead bar, whose bars are timings of a loaded box
(CHANGES.md). One cluster for the module (ray_tpu_torch.init(num_cpus=4)).
"""

import json
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


def _post(port, dep, body=None, request_id=None, timeout=60):
    headers = {"Content-Type": "application/json"}
    if request_id:
        headers["X-Request-Id"] = request_id
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{dep}",
        data=json.dumps(body if body is not None else {}).encode(),
        headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def test_red_metrics_and_queue_gauges_on_merged_endpoint(serve_session):
    """Per-deployment requests_total{code} + request/queue histograms
    and the handle/replica queue-depth gauges all ride the metrics harvest
    onto the cluster-merged /metrics exposition."""

    @serve.deployment(name="tele_red")
    def red(x=0):
        return x

    serve.run(red)
    proxy = serve.start_http(port=0)
    port = ray_tpu_torch.get(proxy.ready.remote())
    try:
        for i in range(6):
            _post(port, "tele_red", {"x": i})
        text = state_api.cluster_metrics_text(fresh=True)
        assert 'ray_tpu_serve_requests_total{' in text
        # per-deployment, code-tagged counter series
        line = next(l for l in text.splitlines()
                    if l.startswith("ray_tpu_serve_requests_total")
                    and 'deployment="tele_red"' in l)
        assert 'code="200"' in line
        assert "ray_tpu_serve_request_seconds_bucket" in text
        assert 'ray_tpu_serve_queue_seconds_bucket' in text
        assert "ray_tpu_serve_handle_queue_depth" in text
        assert "ray_tpu_serve_replica_queue_depth" in text
    finally:
        ray_tpu_torch.kill(proxy)


def test_error_semantics_and_request_ring(serve_session):
    """Satellite: unknown deployment → 404, handler exception → 500,
    configured timeout → 504 — each still recording trace + metrics —
    and the ring's --errors/--slowest/--deployment query surface plus
    the `ray_tpu serve requests` CLI."""

    @serve.deployment(name="tele_flaky")
    def flaky(x=0):
        raise ValueError("boom")

    @serve.deployment(name="tele_slow")
    def slow(x=0):
        time.sleep(1.2)
        return x

    serve.run(flaky)
    serve.run(slow)
    proxy = serve.start_http(port=0, request_timeout_s=0.4)
    port = ray_tpu_torch.get(proxy.ready.remote())
    try:
        codes = {}
        for dep in ("tele_nope", "tele_flaky", "tele_slow"):
            try:
                _post(port, dep)
                codes[dep] = 200
            except urllib.error.HTTPError as e:
                codes[dep] = e.code
                payload = json.loads(e.read())
                assert payload["error"] and payload["request_id"]
        assert codes == {"tele_nope": 404, "tele_flaky": 500,
                         "tele_slow": 504}, codes

        errs = state_api.serve_requests(errors=True)["requests"]
        ring_codes = {e["deployment"]: e["code"] for e in errs}
        assert ring_codes.get("tele_nope") == 404
        assert ring_codes.get("tele_flaky") == 500
        assert ring_codes.get("tele_slow") == 504
        # every captured request carries a trace id (504 included:
        # "timed-out requests must still record their trace")
        assert all(e.get("trace_id") for e in errs)

        only_flaky = state_api.serve_requests(
            deployment="tele_flaky", errors=True)["requests"]
        assert only_flaky and all(e["deployment"] == "tele_flaky"
                                  for e in only_flaky)
        slowest = state_api.serve_requests(slowest=1)["requests"]
        assert slowest and slowest[0]["deployment"] == "tele_slow"

        # timed-out requests still count, code-tagged 504
        text = state_api.cluster_metrics_text(fresh=True)
        assert any('deployment="tele_slow"' in l and 'code="504"' in l
                   for l in text.splitlines()
                   if l.startswith("ray_tpu_serve_requests_total"))

        # CLI: text table + json
        from ray_tpu_torch.scripts.cli import main as cli_main
        addr = ray_tpu_torch.get_gcs_address()
        assert cli_main(["serve", "requests", "--address", addr,
                         "--errors", "--format", "json"]) == 0
        assert cli_main(["serve", "requests", "--address", addr,
                         "--slowest", "3"]) == 0
    finally:
        ray_tpu_torch.kill(proxy)


def test_grpc_proxy_trace_metadata_and_not_found(serve_session):
    """The gRPC ingress honors x-request-id metadata (echoed in the
    trailing metadata) and maps unknown deployments to NOT_FOUND."""
    import grpc

    @serve.deployment(name="tele_grpc")
    def g(x=0):
        return x * 2

    serve.run(g)
    proxy = serve.start_grpc(port=0)
    port = ray_tpu_torch.get(proxy.ready.remote())
    try:
        import pickle
        tid = "cafebabe01234567"
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            fn = channel.unary_unary(
                serve.grpc_proxy.SERVICE_PREFIX + "tele_grpc",
                request_serializer=None, response_deserializer=None)
            resp, call = fn.with_call(
                pickle.dumps(((21,), {}), protocol=5), timeout=60,
                metadata=(("x-request-id", tid),))
            assert pickle.loads(resp) == 42
            trailing = dict(call.trailing_metadata() or ())
            assert trailing.get("x-request-id") == tid
        with pytest.raises(grpc.RpcError) as e:
            serve.grpc_call(f"127.0.0.1:{port}", "tele_missing", 1,
                            timeout=30)
        assert e.value.code() == grpc.StatusCode.NOT_FOUND
        # the grpc ring entries share the http proxies' shape
        errs = state_api.serve_requests(errors=True)["requests"]
        assert any(e["deployment"] == "tele_missing"
                   and e["method"] == "grpc" and e["code"] == 404
                   for e in errs)
    finally:
        ray_tpu_torch.get(proxy.stop.remote(), timeout=30)
        ray_tpu_torch.kill(proxy)


def test_shed_carries_retry_after_and_records_everywhere(serve_session):
    """Satellite: shed responses carry Retry-After, land in the request
    ring as 503s, and count into ray_tpu_serve_shed_total on the merged
    exposition."""

    @serve.deployment(name="fleet_shed", num_replicas=1,
                      max_concurrent_queries=2, max_queued_requests=1)
    def shed(x=0):
        time.sleep(0.5)
        return x

    serve.run(shed)
    proxy = serve.start_http(port=0)
    port = ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    _post(port, "fleet_shed")  # warm: limits learned from routing info
    outcomes = []
    lock = threading.Lock()

    def call(i):
        try:
            _post(port, "fleet_shed", {"x": i})
            with lock:
                outcomes.append((200, None))
        except urllib.error.HTTPError as e:
            with lock:
                outcomes.append((e.code, e.headers.get("Retry-After")))

    ts = [threading.Thread(target=call, args=(i,)) for i in range(10)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    sheds = [o for o in outcomes if o[0] == 503]
    assert sheds, f"nothing shed: {outcomes}"
    assert all(ra is not None for _c, ra in sheds), sheds
    # ring entries: 503s with the shed reason in the error field
    snap = ray_tpu_torch.get(proxy.requests_snapshot.remote(errors=True),
                       timeout=30)
    shed_entries = [e for e in snap if e["code"] == 503]
    assert shed_entries and all(
        "shed" in (e["error"] or "") for e in shed_entries)
    # merged metrics: the shed counter is first-class RED
    text = state_api.cluster_metrics_text(fresh=True)
    assert 'ray_tpu_serve_shed_total{' in text
    line = next(l for l in text.splitlines()
                if l.startswith("ray_tpu_serve_shed_total")
                and 'deployment="fleet_shed"' in l)
    assert 'reason="capacity"' in line


def test_rate_limit_sheds_fast(serve_session):
    """Token-bucket rate limiting: traffic over rate_limit_rps sheds
    with reason=rate_limit even with idle replicas."""

    @serve.deployment(name="fleet_rated", rate_limit_rps=5.0)
    def rated(x=0):
        return x

    serve.run(rated)
    proxy = serve.start_http(port=0)
    port = ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    _post(port, "fleet_rated")  # warm (burst bucket starts full)
    codes = []
    for i in range(30):
        try:
            _post(port, "fleet_rated", {"x": i})
            codes.append(200)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
    assert 503 in codes, codes
    assert codes.count(200) <= 15  # burst (~5) + refill during the loop
