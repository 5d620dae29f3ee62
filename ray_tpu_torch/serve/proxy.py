"""LEGACY threading HTTP ingress (compat shim).

The default ingress is now the per-node asyncio proxy fleet
(serve/_private/proxy_fleet/ — `serve.start_http` starts it); this
ThreadingHTTPServer actor remains only for callers that import
HTTPProxyActor directly. Its thread pool caps HTTP at ~500 req/s while
handles sustain ~1,500 (VERDICT Weak §8, BENCH_SERVE_r07/r08) and it
has no admission control: new code should go through the fleet.

reference parity: serve/_private/proxy.py:122 (per-node HTTP proxy
routing requests into deployment handles). POST/GET /<deployment-name>
with a JSON body; the body (an object → kwargs, anything else → single
positional arg) is passed to the deployment and the JSON result returned.

Request telemetry (see README "Serve request telemetry"): every request
gets a trace id — the inbound ``X-Request-Id`` header when present,
minted otherwise, always echoed back in the response header — adopted
for the handler thread so the handle submit and the replica execution
(and any nested deployment calls) share it in `ray_tpu timeline
--trace-id`. Each hop records spans (parse / route / handle wait /
serialize / write), the proxy counts
``ray_tpu_serve_requests_total{deployment,code}``, and a bounded ring
captures the slowest + all errored requests for `ray_tpu serve
requests`.

Error semantics: unknown deployment → 404, handle timeout
(`serve_request_timeout_s`, default 120s) → 504, malformed JSON → 400,
anything else → 500; every outcome still records its trace + metrics.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from time import perf_counter
from typing import Any, Dict, Optional


class HTTPProxyActor:
    def __init__(self, port: int = 8000,
                 request_timeout_s: Optional[float] = None):
        from ray_tpu_torch._private.config import Config
        from ray_tpu_torch.serve import _telemetry
        from ray_tpu_torch.serve.api import DeploymentHandle

        self._handles: Dict[str, Any] = {}
        self._handles_lock = threading.Lock()
        self._timeout = float(request_timeout_s
                              if request_timeout_s is not None
                              else Config.serve_request_timeout_s)
        self._ring = _telemetry.RequestRing()
        proxy = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, code: int, payload: bytes,
                       trace_id: Optional[str] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                if trace_id:
                    self.send_header("X-Request-Id", trace_id)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _handle(self, body: Any, parse_s: float = 0.0) -> None:
                import ray_tpu_torch
                from ray_tpu_torch._private import spans as spans_lib
                from ray_tpu_torch.serve import _telemetry
                from ray_tpu_torch.serve.api import DeploymentNotFound
                from ray_tpu_torch.util import tracing
                name = self.path.strip("/").split("/")[0]
                trace_id = _telemetry.ingress_trace_id(
                    self.headers.get("X-Request-Id"))
                t_start = perf_counter()
                stages: Dict[str, float] = {"parse_s": parse_s}
                code, err = 200, None
                payload = b""
                with tracing.use_trace(trace_id):
                    with spans_lib.span("serve.proxy.request",
                                        deployment=name) as sp:
                        try:
                            if not name:
                                raise DeploymentNotFound(
                                    "no deployment in path")
                            t0 = perf_counter()
                            with proxy._handles_lock:
                                handle = proxy._handles.get(name)
                                if handle is None:
                                    handle = DeploymentHandle(name)
                                    proxy._handles[name] = handle
                            if isinstance(body, dict):
                                ref = handle.remote(**body)
                            elif body is None:
                                ref = handle.remote()
                            else:
                                ref = handle.remote(body)
                            stages["route_s"] = perf_counter() - t0
                            t0 = perf_counter()
                            result = ray_tpu_torch.get(
                                ref, timeout=proxy._timeout)
                            stages["handle_s"] = perf_counter() - t0
                            t0 = perf_counter()
                            payload = json.dumps(
                                {"result": result}).encode()
                            stages["serialize_s"] = perf_counter() - t0
                        except DeploymentNotFound as e:
                            code, err = 404, str(e)
                            # don't let a path scan grow the handle
                            # cache (and its listener threads) one
                            # entry per bogus name forever
                            with proxy._handles_lock:
                                proxy._handles.pop(name, None)
                        except ray_tpu_torch.exceptions.GetTimeoutError:
                            # the timeout may also be the handle's
                            # internal 30s routing fetch (controller
                            # hung) — report the time that actually
                            # elapsed, not the configured budget
                            code, err = 504, (
                                f"deployment {name!r} did not respond "
                                f"within "
                                f"{perf_counter() - t_start:.1f}s "
                                f"(request timeout "
                                f"{proxy._timeout:g}s)")
                        except Exception as e:  # noqa: BLE001
                            code, err = 500, str(e)
                        sp["code"] = code
                    if err is not None:
                        payload = json.dumps(
                            {"error": err,
                             "request_id": trace_id}).encode()
                    t0 = perf_counter()
                    try:
                        self._reply(code, payload, trace_id)
                    except Exception as e:
                        # client went away mid-write: surface it in the
                        # ring/counter as 499 (client closed request),
                        # not a phantom clean 200
                        code, err = 499, f"response write failed: {e}"
                        raise
                    finally:
                        # record AFTER the response write so the entry
                        # is complete (write_s included) when it is
                        # published — snapshot serialization must never
                        # race a mutating handler thread
                        stages["write_s"] = perf_counter() - t0
                        spans_lib.end("serve.proxy.write", t0,
                                      deployment=name,
                                      bytes=len(payload))
                        _telemetry.record_ingress(
                            proxy._ring, deployment=name or "?",
                            method="http", code=code,
                            trace_id=trace_id,
                            total_s=perf_counter() - t_start,
                            stages=stages, error=err)

            def do_GET(self):
                self._handle(None)

            def do_POST(self):
                t0 = perf_counter()
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b""
                try:
                    body = json.loads(raw) if raw else None
                except json.JSONDecodeError as e:
                    from ray_tpu_torch.serve import _telemetry
                    trace_id = _telemetry.ingress_trace_id(
                        self.headers.get("X-Request-Id"))
                    err = f"invalid JSON body: {e}"
                    _telemetry.record_ingress(
                        proxy._ring,
                        deployment=self.path.strip("/").split("/")[0]
                        or "?",
                        method="http", code=400, trace_id=trace_id,
                        total_s=perf_counter() - t0,
                        stages={"parse_s": perf_counter() - t0},
                        error=err)
                    self._reply(400, json.dumps(
                        {"error": err,
                         "request_id": trace_id}).encode(), trace_id)
                    return
                self._handle(body, parse_s=perf_counter() - t0)

        self._server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="serve-http").start()

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
        self._server.shutdown()
