"""AsyncProxyActor: per-node asyncio ingress (HTTP + gRPC, one loop).

reference parity: serve/_private/proxy.py (HTTPProxy + gRPCProxy share
one event loop per node). Replaces the threading proxy as the default
ingress: request parsing/routing is async, handle submits bridge
through the core worker's done callbacks (async_bridge.py — no
per-request threads), large bytes results stream zero-copy
(http.py Response), admission control sheds overload fast
(admission.py), and a drain lifecycle (stop accepting → finish
in-flight → deregister) makes rolling updates and node removal
invisible to clients.

Request contract (unchanged from the threading proxy — see
serve/proxy.py history): POST/GET /<deployment> with a JSON body
(object → kwargs, anything else → one positional arg) returns
{"result": ...}; errors return {"error", "request_id"} with 404/400/
503/504/500; X-Request-Id is honored/minted/echoed; every request
records spans + RED metrics + the slow/error ring. New:

  - 503 + Retry-After when admission sheds (capacity / rate limit /
    draining), counted in ray_tpu_serve_shed_total{deployment,reason};
  - raw `bytes` results ship as application/octet-stream, streamed in
    bounded chunks straight from the store envelope view (PR-3);
  - requests to @serve.batch deployments with single-positional bodies
    coalesce proxy-side into one replica submit (serve_coalesce_*
    knobs) so the MXU sees fused batches even when every client sends
    one request at a time;
  - replicas replaced under a request (rolling update) retry through a
    forced routing refresh instead of surfacing 5xx.

gRPC rides the same loop and the same generic-service wire contract as
serve/grpc_proxy.py (`/ray_tpu_torch.serve/<deployment>`, pickled
(args, kwargs) in, pickled result out, x-request-id metadata): shed →
RESOURCE_EXHAUSTED with a retry-after trailing-metadata hint.
"""

from __future__ import annotations

import asyncio
import json
import pickle
import threading
from time import perf_counter
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve._private.proxy_fleet import http as fleet_http
from ray_tpu_torch.serve._private.proxy_fleet.admission import (
    AdmissionController, ShedDecision)
from ray_tpu_torch.serve._private.proxy_fleet.async_bridge import await_ref

GRPC_SERVICE_PREFIX = "/ray_tpu_torch.serve/"


def _control_group(fn):
    fn.__ray_tpu_method_options__ = {"concurrency_group": "control"}
    return fn


def _retryable_replica_error(e: BaseException) -> bool:
    """Errors that mean THIS REPLICA is gone, not that the request is
    bad: retried through a forced routing refresh (rolling updates
    replace every replica; in-flight requests must not surface 5xx)."""
    import ray_tpu_torch
    if isinstance(e, (ray_tpu_torch.exceptions.RayActorError,
                      ray_tpu_torch.exceptions.WorkerCrashedError,
                      ray_tpu_torch.exceptions.OwnerDiedError)):
        return True
    # a task error WRAPPING an actor death (executor-side kill lands as
    # RayTaskError(cause=ActorDiedError) on some paths)
    cause = getattr(e, "cause", None)
    if cause is not None and isinstance(
            cause, (ray_tpu_torch.exceptions.RayActorError,
                    ray_tpu_torch.exceptions.WorkerCrashedError)):
        return True
    # transient empty replica set mid-redeploy
    return isinstance(e, RuntimeError) and "has no replicas" in str(e)


class _Coalescer:
    """Event-loop-confined fuser: single-positional requests for one
    @serve.batch deployment collect for up to serve_coalesce_wait_s (or
    serve_coalesce_max_batch) and ship as ONE handle_request_batch
    submit; the replica fans them into its batch queue, so one proxy
    batch becomes one fused forward pass."""

    def __init__(self, proxy: "AsyncProxy", deployment: str):
        self._proxy = proxy
        self._deployment = deployment
        self._pending: List[tuple] = []  # (arg, future)
        self._timer: Optional[asyncio.TimerHandle] = None

    def submit(self, arg: Any) -> "asyncio.Future":
        from ray_tpu_torch._private.config import Config
        fut = self._proxy._loop.create_future()
        self._pending.append((arg, fut))
        if len(self._pending) >= Config.serve_coalesce_max_batch:
            self._flush()
        elif self._timer is None:
            self._timer = self._proxy._loop.call_later(
                Config.serve_coalesce_wait_s, self._flush)
        return fut

    def _flush(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        task = self._proxy._loop.create_task(self._run(batch))
        self._proxy._track_task(task)

    async def _run(self, batch: List[tuple]) -> None:
        try:
            results = await self._proxy._call_batch(
                self._deployment, [arg for arg, _f in batch])
            for (arg, fut), (ok, payload) in zip(batch, results):
                if fut.done():
                    continue
                if ok:
                    fut.set_result(payload)
                else:
                    fut.set_exception(RuntimeError(payload))
            # a short reply (replica bug) must fail its items, not
            # strand them until the request deadline
            for _arg, fut in batch[len(results):]:
                if not fut.done():
                    fut.set_exception(RuntimeError(
                        "batched replica reply missing this item"))
        except BaseException as e:  # noqa: BLE001 — fan the batch's
            for _arg, fut in batch:  # failure out to every waiter
                if not fut.done():
                    fut.set_exception(
                        e if isinstance(e, Exception)
                        else RuntimeError(repr(e)))


class AsyncProxy:
    """The in-process engine (event loop + servers + admission). Split
    from the actor shell so tests can drive it without a cluster
    round trip for every assertion."""

    SUBMIT_POOL_SIZE = 4
    RETRY_ATTEMPTS = 3

    def __init__(self, http_port: int = 8000,
                 grpc_port: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 host: str = "127.0.0.1"):
        import concurrent.futures

        from ray_tpu_torch._private.config import Config
        from ray_tpu_torch.serve import _telemetry

        self._timeout = float(request_timeout_s
                              if request_timeout_s is not None
                              else Config.serve_request_timeout_s)
        self._ring = _telemetry.RequestRing()
        self._handles: Dict[str, Any] = {}
        self._admission = AdmissionController()
        self._coalescers: Dict[str, _Coalescer] = {}
        self._tasks: set = set()
        self._draining = False
        self._drained = threading.Event()
        self._host = host
        # bounded pool for the handle's blocking routing calls (refresh
        # RPC, queue-len probes) and resolved-ref materializes — shared
        # by every request, NOT per-request
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.SUBMIT_POOL_SIZE,
            thread_name_prefix="serve-proxy-submit")
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True,
            name="serve-async-proxy")
        self._thread.start()
        self._http = fleet_http.HTTPServer(self._handle_http,
                                           host=host)
        self.http_port = asyncio.run_coroutine_threadsafe(
            self._http.start(http_port), self._loop).result(timeout=30)
        self.grpc_port: Optional[int] = None
        self._grpc_server = None
        if grpc_port is not None:
            self.grpc_port = asyncio.run_coroutine_threadsafe(
                self._start_grpc(grpc_port), self._loop).result(
                timeout=30)

    # ---- shared dispatch machinery ----------------------------------

    def _track_task(self, task: "asyncio.Task") -> None:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _handle(self, name: str):
        """Handle cache lookup-or-create. MUST run on an executor
        thread: DeploymentHandle.__init__ resolves the controller (a
        blocking RPC the event loop can never make)."""
        handle = self._handles.get(name)
        if handle is None:
            from ray_tpu_torch.serve.api import DeploymentHandle
            handle = DeploymentHandle(name)
            # benign create race between executor threads: last one
            # wins, both route correctly
            self._handles[name] = handle
        return handle

    def _refresh_admission(self, name: str, handle: Any) -> None:
        extra = getattr(handle, "_routing_extra", None) or {}
        self._admission.update_limits(
            name,
            replicas=extra.get("replica_count", 1),
            max_concurrent_queries=extra.get(
                "max_concurrent_queries", 16),
            max_queued_requests=extra.get("max_queued_requests", -1),
            rate_limit_rps=extra.get("rate_limit_rps", 0.0))

    async def _submit_and_get(self, name: str, submit_fn, trace_id: str,
                              deadline: float,
                              stages: Optional[Dict[str, float]] = None
                              ) -> Any:
        """The shared async request engine: run `submit_fn(handle)` on
        the bounded executor (the routing path blocks on controller
        RPCs and queue-len probes), await the returned ref via the
        done-callback bridge, then materialize — also on the executor
        (a large result's store fetch must not stall the loop).
        Replica-death errors (rolling update replaced the replica set,
        chaos killed a worker) force a routing refresh and retry inside
        the request's deadline instead of surfacing 5xx."""
        import ray_tpu_torch
        from ray_tpu_torch.util import tracing
        last: Optional[BaseException] = None
        for attempt in range(self.RETRY_ATTEMPTS + 1):
            remaining = deadline - perf_counter()
            if remaining <= 0:
                raise ray_tpu_torch.exceptions.GetTimeoutError(
                    f"deployment {name!r} timed out")

            def _submit():
                handle = self._handle(name)
                with tracing.use_trace(trace_id):
                    if attempt > 0:
                        handle._refresh(force=True)
                    return handle, submit_fn(handle)

            try:
                t0 = perf_counter()
                handle, ref = await self._loop.run_in_executor(
                    self._pool, _submit)
                if stages is not None:
                    stages["route_s"] = perf_counter() - t0
                self._refresh_admission(name, handle)
                # budget re-read AFTER the (blocking) submit phase: a
                # slow routing fetch must shrink the await window, or a
                # result landing just past the deadline beats the stale
                # timer and a deserved 504 becomes a late 200
                await await_ref(ref, self._loop,
                                max(0.0, deadline - perf_counter()))
                return await self._loop.run_in_executor(
                    self._pool,
                    lambda: ray_tpu_torch.get(ref, timeout=30))
            except asyncio.TimeoutError:
                raise ray_tpu_torch.exceptions.GetTimeoutError(
                    f"deployment {name!r} timed out") from None
            except Exception as e:  # noqa: BLE001 — split retryable
                if not _retryable_replica_error(e) or \
                        attempt >= self.RETRY_ATTEMPTS:
                    raise
                last = e
                # replicas moved under us (rolling update / chaos
                # kill): give the controller a beat to publish the
                # replacement set, then retry through a forced refresh
                await asyncio.sleep(min(0.2 * (attempt + 1),
                                        max(0.0, deadline
                                            - perf_counter())))
        raise last  # pragma: no cover — loop always returns/raises

    async def _call_batch(self, name: str,
                          items: List[Any]) -> List[tuple]:
        """Coalesced path: ONE handle_request_batch submit for N
        single-positional requests; returns [(ok, payload), ...]."""
        return await self._submit_and_get(
            name, lambda handle: handle._submit_batch(items),
            trace_id="", deadline=perf_counter() + self._timeout)

    def _coalescible(self, name: str, args: tuple,
                     kwargs: Dict[str, Any]) -> bool:
        if kwargs or len(args) != 1:
            return False
        handle = self._handles.get(name)
        extra = getattr(handle, "_routing_extra", None) or {}
        return bool(extra.get("coalesce"))

    async def _dispatch(self, name: str, args: tuple,
                        kwargs: Dict[str, Any], trace_id: str,
                        stages: Optional[Dict[str, float]] = None
                        ) -> Any:
        import ray_tpu_torch
        deadline = perf_counter() + self._timeout
        if self._coalescible(name, args, kwargs):
            co = self._coalescers.get(name)
            if co is None:
                co = self._coalescers[name] = _Coalescer(self, name)
            try:
                # own deadline: a batch reply that never resolves this
                # item's future (replica bug, lost result) must 504,
                # not park the request coroutine forever
                return await asyncio.wait_for(co.submit(args[0]),
                                              self._timeout)
            except asyncio.TimeoutError:
                raise ray_tpu_torch.exceptions.GetTimeoutError(
                    f"deployment {name!r} timed out") from None
        return await self._submit_and_get(
            name,
            lambda handle: handle._submit(args, kwargs, model_id="",
                                          stream=False),
            trace_id, deadline, stages)

    def _record_span(self, name: str, t0: float, trace_id: str,
                     **attrs: Any) -> None:
        """Span record on the (single-threaded) event loop: the span
        TLS is set only for the synchronous record call, so concurrent
        request coroutines can't bleed trace ids into each other."""
        from ray_tpu_torch._private import spans as spans_lib
        prev = spans_lib.get_current_trace()
        spans_lib.set_current_trace(trace_id)
        try:
            spans_lib.end(name, t0, **attrs)
        finally:
            spans_lib.set_current_trace(prev)

    def _shed_entry(self, deployment: str, method: str,
                    decision: ShedDecision, trace_id: str,
                    t_start: float) -> None:
        from ray_tpu_torch.serve import _telemetry
        _telemetry.count_shed(deployment, decision.reason)
        _telemetry.record_ingress(
            self._ring, deployment=deployment or "?", method=method,
            code=503, trace_id=trace_id,
            total_s=perf_counter() - t_start,
            stages={"shed": 1.0}, error=f"shed: {decision.detail}")

    # ---- HTTP -------------------------------------------------------

    async def _handle_http(self, req: "fleet_http.Request"
                           ) -> "fleet_http.Response":
        import ray_tpu_torch
        from ray_tpu_torch.serve import _telemetry
        from ray_tpu_torch.serve.api import DeploymentNotFound
        t_start = perf_counter()
        name = req.path.strip("/").split("/")[0].split("?")[0]
        trace_id = _telemetry.ingress_trace_id(
            req.headers.get("x-request-id"))
        if name == "-":  # /-/healthz: fleet liveness, no deployment
            body = json.dumps({
                "status": "draining" if self._draining else "ok",
                "inflight": self._http.inflight}).encode()
            return fleet_http.Response(
                503 if self._draining else 200, body)
        stages: Dict[str, float] = {}
        code, err = 200, None
        headers = {"X-Request-Id": trace_id}
        body_out: Any = b""
        # parse: JSON body -> call shape
        t0 = perf_counter()
        args: tuple = ()
        kwargs: Dict[str, Any] = {}
        parse_error = None
        if req.body:
            try:
                parsed = json.loads(req.body)
                if isinstance(parsed, dict):
                    kwargs = parsed
                else:
                    args = (parsed,)
            except json.JSONDecodeError as e:
                parse_error = f"invalid JSON body: {e}"
        stages["parse_s"] = perf_counter() - t0
        if parse_error is not None:
            code, err = 400, parse_error
        elif not name:
            code, err = 404, "no deployment in path"
        else:
            # draining connections already close after their in-flight
            # response (http.py) — requests that got this far finish
            decision = self._admission.try_admit(name)
            if decision is not None:
                self._shed_entry(name, "http", decision, trace_id,
                                 t_start)
                return self._shed_response(decision, trace_id)
            try:
                t0 = perf_counter()
                result = await self._dispatch(name, args, kwargs,
                                              trace_id, stages)
                stages["handle_s"] = perf_counter() - t0 \
                    - stages.get("route_s", 0.0)
                t0 = perf_counter()
                if isinstance(result, (bytes, bytearray, memoryview)):
                    # zero-copy streaming: the store-envelope view
                    # flows straight to the socket in bounded chunks
                    body_out = result
                    headers["Content-Type"] = "application/octet-stream"
                else:
                    body_out = json.dumps({"result": result}).encode()
                stages["serialize_s"] = perf_counter() - t0
            except DeploymentNotFound as e:
                code, err = 404, str(e)
                # a path scan must not grow the handle cache forever
                self._handles.pop(name, None)
                self._coalescers.pop(name, None)
            except ray_tpu_torch.exceptions.GetTimeoutError:
                code, err = 504, (
                    f"deployment {name!r} did not respond within "
                    f"{perf_counter() - t_start:.1f}s (request "
                    f"timeout {self._timeout:g}s)")
            except Exception as e:  # noqa: BLE001
                code, err = 500, str(e)
            finally:
                self._admission.release(name)
        if err is not None:
            body_out = json.dumps({"error": err,
                                   "request_id": trace_id}).encode()
        self._record_span("serve.proxy.request",
                          t_start, trace_id,
                          deployment=name, code=code)
        resp = fleet_http.Response(code, body_out, headers=headers)
        ring = self._ring

        def _on_written(nbytes: int, write_s: float,
                        write_err: Optional[str]) -> None:
            # record AFTER the write so the ring entry is complete
            stages["write_s"] = write_s
            final_code, final_err = code, err
            if write_err is not None:
                final_code = 499
                final_err = f"response write failed: {write_err}"
            self._record_span("serve.proxy.write",
                              perf_counter() - write_s, trace_id,
                              deployment=name, bytes=nbytes)
            _telemetry.record_ingress(
                ring, deployment=name or "?", method="http",
                code=final_code, trace_id=trace_id,
                total_s=perf_counter() - t_start,
                stages=stages, error=final_err)

        resp.on_written = _on_written
        return resp

    def _shed_response(self, decision: ShedDecision,
                       trace_id: str) -> "fleet_http.Response":
        body = json.dumps({
            "error": f"shed ({decision.reason}): {decision.detail}",
            "request_id": trace_id,
            "retry_after_s": decision.retry_after_s}).encode()
        return fleet_http.Response(
            503, body,
            headers={"X-Request-Id": trace_id,
                     "Retry-After": f"{decision.retry_after_s:g}"})

    # ---- gRPC -------------------------------------------------------

    async def _start_grpc(self, port: int) -> int:
        import grpc
        import grpc.aio
        proxy = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method
                if not method.startswith(GRPC_SERVICE_PREFIX):
                    return None
                name = method[len(GRPC_SERVICE_PREFIX):]

                async def unary(request: bytes, context):
                    return await proxy._handle_grpc(name, request,
                                                    context)

                return grpc.unary_unary_rpc_method_handler(
                    unary, request_deserializer=None,
                    response_serializer=None)

        server = grpc.aio.server(
            options=[("grpc.max_receive_message_length", -1),
                     ("grpc.max_send_message_length", -1)])
        server.add_generic_rpc_handlers((_Generic(),))
        bound = server.add_insecure_port(f"{self._host}:{port}")
        if bound == 0:
            raise OSError(f"gRPC proxy could not bind "
                          f"{self._host}:{port}")
        await server.start()
        self._grpc_server = server
        return bound

    async def _handle_grpc(self, name: str, request: bytes,
                           context) -> bytes:
        import grpc

        import ray_tpu_torch
        from ray_tpu_torch.serve import _telemetry
        from ray_tpu_torch.serve.api import DeploymentNotFound
        t_start = perf_counter()
        meta = dict(context.invocation_metadata() or ())
        trace_id = _telemetry.ingress_trace_id(meta.get("x-request-id"))
        context.set_trailing_metadata((("x-request-id", trace_id),))
        stages: Dict[str, float] = {}
        code, err, status = 200, None, None
        out = b""
        decision = self._admission.try_admit(name)
        if decision is not None:
            self._shed_entry(name, "grpc", decision, trace_id, t_start)
            context.set_trailing_metadata(
                (("x-request-id", trace_id),
                 ("retry-after", f"{decision.retry_after_s:g}")))
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"shed ({decision.reason}): {decision.detail}")
        try:
            t0 = perf_counter()
            try:
                args, kwargs = pickle.loads(request) if request \
                    else ((), {})
            except Exception as e:
                raise ValueError(f"bad request payload: {e}") from e
            stages["parse_s"] = perf_counter() - t0
            t0 = perf_counter()
            result = await self._dispatch(name, tuple(args),
                                          dict(kwargs), trace_id,
                                          stages)
            stages["handle_s"] = perf_counter() - t0 \
                - stages.get("route_s", 0.0)
            t0 = perf_counter()
            out = pickle.dumps(result, protocol=5)
            stages["serialize_s"] = perf_counter() - t0
        except DeploymentNotFound as e:
            code, err = 404, str(e)
            status = grpc.StatusCode.NOT_FOUND
            self._handles.pop(name, None)
        except ray_tpu_torch.exceptions.GetTimeoutError:
            code = 504
            err = (f"deployment {name!r} did not respond within "
                   f"{perf_counter() - t_start:.1f}s (request timeout "
                   f"{self._timeout:g}s)")
            status = grpc.StatusCode.DEADLINE_EXCEEDED
        except Exception as e:  # noqa: BLE001
            code, err = 500, str(e)
            status = grpc.StatusCode.INTERNAL
        finally:
            self._admission.release(name)
        self._record_span("serve.proxy.request", t_start, trace_id,
                          deployment=name, code=code, transport="grpc")
        _telemetry.record_ingress(
            self._ring, deployment=name, method="grpc", code=code,
            trace_id=trace_id, total_s=perf_counter() - t_start,
            stages=stages, error=err)
        if err is not None:
            await context.abort(status, err)
        return out

    # ---- lifecycle --------------------------------------------------

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Stop accepting, finish in-flight, then report drained.
        Blocking (called from an actor method thread, never the
        loop)."""
        from ray_tpu_torch._private.config import Config
        budget = float(timeout_s if timeout_s is not None
                       else Config.serve_drain_timeout_s)
        self._draining = True
        ok = asyncio.run_coroutine_threadsafe(
            self._http.drain(budget), self._loop).result(
            timeout=budget + 10)
        if self._grpc_server is not None:
            async def _stop_grpc():
                await self._grpc_server.stop(grace=budget)
            try:
                asyncio.run_coroutine_threadsafe(
                    _stop_grpc(), self._loop).result(
                    timeout=budget + 10)
            except Exception:  # noqa: BLE001 - already stopping
                pass
        self._drained.set()
        return ok

    @property
    def draining(self) -> bool:
        return self._draining

    def drained(self) -> bool:
        return self._drained.is_set()

    def inflight(self) -> int:
        return self._http.inflight + self._admission.inflight()

    def stop(self) -> None:
        if not self._drained.is_set():
            try:
                self.drain(timeout_s=2.0)
            except Exception:  # noqa: BLE001 - force-stop below anyway
                pass

        async def _shutdown():
            await self._http.stop()
            for t in list(self._tasks):
                t.cancel()

        try:
            asyncio.run_coroutine_threadsafe(
                _shutdown(), self._loop).result(timeout=10)
        except Exception:  # noqa: BLE001 - loop wedged; stop it anyway
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=False)

    def status(self) -> Dict[str, Any]:
        return {
            "http_port": self.http_port,
            "grpc_port": self.grpc_port,
            "draining": self._draining,
            "drained": self._drained.is_set(),
            "inflight": self._http.inflight,
            "admission": self._admission.snapshot(),
            "shed_total": self._admission.shed_total,
        }


class AsyncProxyActor:
    """Actor shell over AsyncProxy (the fleet manager starts one per
    node; serve.start_http starts one on the local node). Control-group
    methods stay responsive while a drain blocks the default group."""

    def __init__(self, http_port: int = 8000,
                 grpc_port: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 node_id: str = ""):
        self._proxy = AsyncProxy(http_port=http_port,
                                 grpc_port=grpc_port,
                                 request_timeout_s=request_timeout_s)
        self.node_id = node_id
        # the RAW constructor args (0 = ephemeral port, None = config
        # default), not the resolved values: the fleet's adopt path
        # compares these against its armed config — a predecessor from
        # an older fleet generation must not serve a newer config
        self._armed = {"http_port": http_port, "grpc_port": grpc_port,
                       "request_timeout_s": request_timeout_s}

    @_control_group
    def armed_config(self) -> Dict[str, Any]:
        return dict(self._armed)

    @_control_group
    def ready(self) -> int:
        return self._proxy.http_port

    @_control_group
    def ports(self) -> Dict[str, Optional[int]]:
        return {"http": self._proxy.http_port,
                "grpc": self._proxy.grpc_port}

    @_control_group
    def ping(self) -> str:
        return "drained" if self._proxy.drained() else \
            ("draining" if self._proxy.draining else "pong")

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        return self._proxy.drain(timeout_s)

    @_control_group
    def drained(self) -> bool:
        return self._proxy.drained()

    @_control_group
    def status(self) -> Dict[str, Any]:
        out = self._proxy.status()
        out["node_id"] = self.node_id
        return out

    @_control_group
    def requests_snapshot(self, deployment: Optional[str] = None,
                          errors: bool = False,
                          slowest: Optional[int] = None):
        """Captured slow/errored requests (see _telemetry.RequestRing)
        — queried by util.state.serve_requests() across all proxies."""
        return self._proxy._ring.snapshot(
            deployment=deployment, errors=errors, slowest=slowest)

    def stop(self) -> None:
        self._proxy.stop()
