"""gRPC ingress for Serve deployments.

reference parity: serve/_private/proxy.py:556 (gRPCProxy) — the
reference runs an HTTP proxy AND a gRPC proxy per node; its gRPC proxy
dispatches user-registered servicer methods to deployment handles. Here
the service is generic (grpc.GenericRpcHandler — no protoc step): the
method path selects the deployment (`/ray_tpu_torch.serve/<deployment>`), the
request payload is a pickled (args, kwargs) tuple, and the response is
the pickled result; `grpc_call` is the matching client helper. Routing
reuses DeploymentHandle (queue-aware P2C + long-poll push), exactly as
the reference's proxies route through handles.

Request telemetry mirrors the HTTP proxy (README "Serve request
telemetry"): the ``x-request-id`` invocation-metadata entry is honored
(minted otherwise) and echoed back in the trailing metadata, spans +
RED metrics record each hop, and the per-proxy ring captures slow and
errored requests. Error semantics: unknown deployment → NOT_FOUND,
handle timeout (`serve_request_timeout_s`, bounded by the client
deadline) → DEADLINE_EXCEEDED, anything else → INTERNAL.
"""

from __future__ import annotations

import pickle
import threading
from time import perf_counter
from typing import Any, Dict, Optional

SERVICE_PREFIX = "/ray_tpu_torch.serve/"

# gRPC status → the HTTP-ish code the RED counter + request ring use,
# so `ray_tpu serve requests` reads uniformly across both ingresses.
_CODE_OK = 200
_CODE_NOT_FOUND = 404
_CODE_INTERNAL = 500
_CODE_TIMEOUT = 504


class GRPCProxyActor:
    """Per-node gRPC ingress actor (start with serve.start_grpc)."""

    def __init__(self, port: int = 9000, max_workers: int = 16,
                 request_timeout_s: Optional[float] = None):
        from concurrent import futures

        import grpc

        from ray_tpu_torch._private.config import Config
        from ray_tpu_torch.serve import _telemetry

        self._handles: Dict[str, Any] = {}
        self._handles_lock = threading.Lock()
        self._timeout = float(request_timeout_s
                              if request_timeout_s is not None
                              else Config.serve_request_timeout_s)
        self._ring = _telemetry.RequestRing()
        proxy = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method
                if not method.startswith(SERVICE_PREFIX):
                    return None
                name = method[len(SERVICE_PREFIX):]

                def unary(request: bytes, context):
                    import ray_tpu_torch
                    from ray_tpu_torch._private import spans as spans_lib
                    from ray_tpu_torch.serve import _telemetry
                    from ray_tpu_torch.serve.api import DeploymentNotFound
                    from ray_tpu_torch.util import tracing
                    meta = dict(context.invocation_metadata() or ())
                    trace_id = _telemetry.ingress_trace_id(
                        meta.get("x-request-id"))
                    context.set_trailing_metadata(
                        (("x-request-id", trace_id),))
                    # bound by the CLIENT's deadline so abandoned
                    # calls release their worker thread instead of
                    # blocking the bounded executor for the full
                    # configured timeout
                    remaining = context.time_remaining()
                    timeout = min(proxy._timeout, remaining) \
                        if remaining is not None else proxy._timeout
                    t_start = perf_counter()
                    stages: Dict[str, float] = {}
                    code, err, status = _CODE_OK, None, None
                    out = b""
                    with tracing.use_trace(trace_id):
                        with spans_lib.span("serve.proxy.request",
                                            deployment=name,
                                            transport="grpc") as sp:
                            try:
                                out = proxy._dispatch(
                                    name, request, timeout, stages)
                            except DeploymentNotFound as e:
                                code, err = _CODE_NOT_FOUND, str(e)
                                status = grpc.StatusCode.NOT_FOUND
                                # don't let a path scan grow the
                                # handle cache one entry per bogus
                                # name forever
                                with proxy._handles_lock:
                                    proxy._handles.pop(name, None)
                            except ray_tpu_torch.exceptions.GetTimeoutError:
                                # may be the handle's internal routing
                                # fetch timing out — report elapsed
                                # time, not the configured budget
                                code = _CODE_TIMEOUT
                                err = (f"deployment {name!r} did not "
                                       f"respond within "
                                       f"{perf_counter() - t_start:.1f}"
                                       f"s (request timeout "
                                       f"{timeout:g}s)")
                                status = \
                                    grpc.StatusCode.DEADLINE_EXCEEDED
                            except Exception as e:  # noqa: BLE001
                                code, err = _CODE_INTERNAL, str(e)
                                status = grpc.StatusCode.INTERNAL
                            sp["code"] = code
                    _telemetry.record_ingress(
                        proxy._ring, deployment=name, method="grpc",
                        code=code, trace_id=trace_id,
                        total_s=perf_counter() - t_start,
                        stages=stages, error=err)
                    if err is not None:
                        context.abort(status, err)
                    return out

                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=None,   # raw bytes in
                    response_serializer=None)    # raw bytes out

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[("grpc.max_receive_message_length", -1),
                     ("grpc.max_send_message_length", -1)])
        self._server.add_generic_rpc_handlers((_Generic(),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")
        if self.port == 0:
            # grpc reports bind failure by returning port 0, not raising
            raise OSError(f"gRPC proxy could not bind 127.0.0.1:{port}")
        self._server.start()

    def _dispatch(self, name: str, request: bytes, timeout: float,
                  stages: Optional[Dict[str, float]] = None) -> bytes:
        import ray_tpu_torch
        from ray_tpu_torch.serve.api import DeploymentHandle

        stages = stages if stages is not None else {}
        t0 = perf_counter()
        with self._handles_lock:
            handle = self._handles.get(name)
            if handle is None:
                handle = DeploymentHandle(name)
                self._handles[name] = handle
        args, kwargs = pickle.loads(request) if request else ((), {})
        stages["parse_s"] = perf_counter() - t0
        t0 = perf_counter()
        ref = handle.remote(*args, **kwargs)
        stages["route_s"] = perf_counter() - t0
        t0 = perf_counter()
        result = ray_tpu_torch.get(ref, timeout=timeout)
        stages["handle_s"] = perf_counter() - t0
        t0 = perf_counter()
        out = pickle.dumps(result, protocol=5)
        stages["serialize_s"] = perf_counter() - t0
        return out

    def ready(self) -> int:
        return self.port

    def requests_snapshot(self, deployment: Optional[str] = None,
                          errors: bool = False,
                          slowest: Optional[int] = None):
        """Captured slow/errored requests (see _telemetry.RequestRing)
        — queried by util.state.serve_requests() across all proxies."""
        return self._ring.snapshot(deployment=deployment, errors=errors,
                                   slowest=slowest)

    def stop(self) -> None:
        # stop() is async in grpc: wait the returned event so callers
        # can rebind the port immediately after this returns (the HTTP
        # proxy's shutdown() blocks the same way)
        self._server.stop(grace=1.0).wait()


def start_grpc(port: int = 9000,
               request_timeout_s: Optional[float] = None):
    """Start the gRPC ingress actor (reference serve start with
    gRPC options); returns its handle (.ready.remote() -> bound port).
    The actor gets a unique cluster name (SERVE_PROXY_GRPC_*, namespace
    "serve") so the request-telemetry query plane can enumerate it."""
    import uuid as _uuid

    import ray_tpu_torch
    cls = ray_tpu_torch.remote(GRPCProxyActor)
    proxy = cls.options(
        num_cpus=0.1, max_concurrency=8,
        name=f"SERVE_PROXY_GRPC_{_uuid.uuid4().hex[:8]}",
        namespace="serve").remote(port, request_timeout_s=request_timeout_s)
    ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    return proxy


def grpc_call(address: str, deployment: str, *args: Any,
              timeout: float = 120.0, request_id: Optional[str] = None,
              **kwargs: Any) -> Any:
    """Client helper: call `deployment` through a gRPC proxy at
    `address` ("host:port"). `request_id` rides the x-request-id
    metadata and becomes the request's trace id end to end."""
    import grpc

    with grpc.insecure_channel(
            address,
            options=[("grpc.max_receive_message_length", -1),
                     ("grpc.max_send_message_length", -1)]) as channel:
        fn = channel.unary_unary(
            SERVICE_PREFIX + deployment,
            request_serializer=None,
            response_deserializer=None)
        payload = pickle.dumps((args, kwargs), protocol=5)
        metadata = (("x-request-id", request_id),) if request_id else None
        return pickle.loads(fn(payload, timeout=timeout,
                               metadata=metadata))
