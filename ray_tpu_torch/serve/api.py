"""Serve public API: @deployment, run, handles, HTTP ingress.

reference parity: python/ray/serve/api.py (serve.deployment / serve.run)
+ handle API (serve/handle.py). The controller is a named actor; handles
resolve replica sets through it and route power-of-two-choices
(reference router.py:893 PowerOfTwoChoicesReplicaScheduler).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import (CONTROLLER_NAME, ServeController,
                                      replica_ping)

_NAMESPACE = "serve"


class DeploymentNotFound(Exception):
    """No deployment by that name is registered with the controller —
    the ingress proxies map this to 404 / NOT_FOUND (a missing route is
    the CLIENT's error; only real replica/infrastructure failures may
    surface as 5xx)."""


def _get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=_NAMESPACE)
    except Exception:  # noqa: BLE001 - not running yet
        pass
    cls = ray_tpu_torch.remote(ServeController)
    try:
        # "control" group hosts blocked listen_for_change long-polls;
        # deploy/delete/get_routing_info stay responsive on the default
        # group however many listeners are armed.
        return cls.options(name=CONTROLLER_NAME, namespace=_NAMESPACE,
                           num_cpus=0.1, max_concurrency=8,
                           concurrency_groups={"control": 24}).remote()
    except ValueError:
        # raced another creator; the name is now taken
        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=_NAMESPACE)


@dataclass
class AutoscalingConfig:
    """reference serve/config.py AutoscalingConfig (queue-depth driven)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0


@dataclass
class Deployment:
    """The declarative unit (reference serve/deployment.py Deployment)."""

    func_or_class: Any
    name: str
    num_replicas: int = 1
    max_concurrent_queries: int = 16
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    # Ingress admission control (proxy_fleet/admission.py): requests
    # admitted beyond replica capacity before the proxies shed with
    # 503 + Retry-After (-1 = Config.serve_max_queued_per_deployment),
    # and a per-proxy token-bucket rate limit in req/s (0 = unlimited).
    max_queued_requests: int = -1
    rate_limit_rps: float = 0.0

    def options(self, **kwargs: Any) -> "Deployment":
        import copy
        new = copy.copy(self)
        for k, v in kwargs.items():
            if not hasattr(new, k):
                raise ValueError(f"unknown deployment option {k!r}")
            setattr(new, k, v)
        return new

    def bind(self, *args: Any, **kwargs: Any) -> "Application":
        return Application(self, args, kwargs)


@dataclass
class Application:
    deployment: Deployment
    init_args: tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)


def deployment(_func_or_class: Any = None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_concurrent_queries: int = 16,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               max_queued_requests: int = -1,
               rate_limit_rps: float = 0.0):
    """@serve.deployment decorator (reference api.py:deployment)."""

    def wrap(target: Any) -> Deployment:
        return Deployment(
            func_or_class=target,
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            ray_actor_options=dict(ray_actor_options or {}),
            autoscaling_config=autoscaling_config,
            max_queued_requests=max_queued_requests,
            rate_limit_rps=rate_limit_rps)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


class DeploymentHandle:
    """Client-side handle with queue-aware power-of-two-choices routing
    (reference router.py:893 PowerOfTwoChoicesReplicaScheduler): pick
    two random replicas, probe each one's SERVER-SIDE queue length
    (executing + queued, reported by the replica's control concurrency
    group — visible work from every caller, not just this handle), and
    send to the shorter queue. Probes are cached briefly and adjusted
    by this handle's own in-flight deltas between probes; replicas at
    or over max_concurrent_queries are avoided while any candidate has
    room."""

    REFRESH_PERIOD_S = 2.0
    PROBE_TTL_S = 0.25
    PROBE_TIMEOUT_S = 2.0

    def __init__(self, deployment_name: str, controller=None):
        self.deployment_name = deployment_name
        self._controller = controller or _get_or_create_controller()
        self._replicas: List[Any] = []
        self._max_queries = 0  # 0 = unknown/unlimited
        # replica actor id -> (stamp, loaded multiplexed model ids)
        self._model_cache: Dict[str, Any] = {}
        # in-flight keyed by replica ACTOR id (stable across replica-set
        # refreshes; index-keyed counts would drift onto the wrong actor
        # whenever the controller replaces a dead replica)
        self._in_flight: Dict[str, int] = {}
        # last probed server-side queue length + local delta since probe
        self._probed: Dict[str, float] = {}   # key -> (stamp)
        self._probe_len: Dict[str, int] = {}  # key -> server queue len
        self._probe_delta: Dict[str, int] = {}  # sends since probe
        self._lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        # Lazy first refresh (on first .remote()): an eager call home
        # would deadlock when a handle is reconstructed INSIDE the
        # controller's own handler thread (deployment composition passes
        # handles through deploy()'s init args).
        self._last_refresh = 0.0
        self._listener_started = False
        # False once the controller reports the name unknown/deleted —
        # routes _pick's empty-replica failure to DeploymentNotFound
        # (ingress 404) instead of a generic 500
        self._exists = True
        # request telemetry: harvest-time queue-depth gauge (weak
        # registration; see serve/_telemetry.py)
        from ray_tpu_torch.serve import _telemetry
        _telemetry.register_handle(self)

    def _refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        # the freshness short-circuit only applies once we HAVE replicas:
        # a concurrent first caller must block for the in-flight fetch
        # rather than race ahead into an empty replica list
        if not force and self._replicas and \
                now - self._last_refresh < self.REFRESH_PERIOD_S:
            return
        with self._refresh_lock:
            if self._replicas and \
                    time.monotonic() - self._last_refresh < self.REFRESH_PERIOD_S:
                return  # another thread refreshed while we waited
            # singleflight by design: _refresh_lock exists ONLY to make
            # concurrent first callers block for this one in-flight
            # controller fetch instead of racing into an empty replica
            # list; no other state hides behind it
            info = ray_tpu_torch.get(  # graftlint: disable=RT015
                self._controller.get_routing_info.remote(
                    self.deployment_name), timeout=30)
            self._apply_routing_info(info)
            self._last_refresh = time.monotonic()
            # no listener for a name the controller doesn't know: a
            # 404 flood must not spawn a parked thread per request
            # (the next successful refresh arms it)
            if self._exists:
                self._ensure_listener()

    def _apply_routing_info(self, info: Dict[str, Any]) -> None:
        replicas = info["replicas"]
        with self._lock:
            # snapshot ordering guard: a slow poll response racing the
            # push listener must not roll the replica set back
            version = info.get("snapshot_id", 0)
            if version < getattr(self, "_routing_version", 0):
                return
            self._routing_version = version
            self._replicas = replicas
            self._exists = bool(info.get("exists", True))
            self._max_queries = info.get("max_concurrent_queries", 0)
            # admission/coalescing hints for the ingress fleet (the
            # proxy derives per-deployment shed limits from these)
            self._routing_extra = {
                "replica_count": len(replicas),
                "max_concurrent_queries":
                    info.get("max_concurrent_queries", 0) or 16,
                "max_queued_requests":
                    info.get("max_queued_requests", -1),
                "rate_limit_rps": info.get("rate_limit_rps", 0.0),
                "coalesce": bool(info.get("coalesce", False)),
            }
            live = {r._actor_id.hex() for r in replicas}
            self._in_flight = {k: v for k, v in self._in_flight.items()
                               if k in live}
            self._model_cache = {
                k: v for k, v in self._model_cache.items()
                if k in live}

    # ---- long-poll push (reference long_poll.py:30 LongPollClient) --
    def _ensure_listener(self) -> None:
        """Start the push listener: a daemon thread parked in the
        controller's listen_for_change, applying routing updates the
        moment they happen instead of at the next REFRESH_PERIOD poll.
        Holds only a weakref so an abandoned handle's thread exits."""
        if self._listener_started:
            return
        self._listener_started = True
        import weakref
        ref = weakref.ref(self)
        threading.Thread(target=_listen_loop, args=(ref,), daemon=True,
                         name=f"serve-listen-{self.deployment_name}"
                         ).start()

    def __reduce__(self):
        # picklable so deployments can compose: a replica holding a
        # handle to a downstream deployment (reference serve app graphs)
        # reconstructs it against its own controller connection
        return (DeploymentHandle, (self.deployment_name,))

    def _queue_len(self, replica) -> int:
        """Server-side ongoing count for one replica, probe-cached for
        PROBE_TTL_S with local sends since the probe added on top."""
        key = replica._actor_id.hex()
        now = time.monotonic()
        with self._lock:
            fresh = now - self._probed.get(key, 0.0) < self.PROBE_TTL_S
            if fresh:
                return (self._probe_len.get(key, 0)
                        + self._probe_delta.get(key, 0))
        try:
            qlen = ray_tpu_torch.get(replica.queue_len.remote(),
                               timeout=self.PROBE_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — probe failure: fall back to
            # the handle-local count, and NEGATIVE-CACHE the failure so
            # a dead/restarting replica costs one timeout per TTL, not
            # one per request
            with self._lock:
                self._probed[key] = time.monotonic()
                self._probe_len[key] = self._in_flight.get(key, 0)
                self._probe_delta[key] = 0
                return self._probe_len[key]
        with self._lock:
            self._probed[key] = time.monotonic()
            self._probe_len[key] = int(qlen)
            self._probe_delta[key] = 0
            return int(qlen)

    def _model_ids(self, replica) -> List[str]:
        """Loaded multiplexed-model ids for one replica, probe-cached."""
        key = replica._actor_id.hex()
        now = time.monotonic()
        with self._lock:
            cached = self._model_cache.get(key)
            if cached is not None and now - cached[0] < 2.0:
                return cached[1]
        try:
            ids = list(ray_tpu_torch.get(
                replica.multiplexed_model_ids.remote(),
                timeout=self.PROBE_TIMEOUT_S))
        except Exception:  # noqa: BLE001
            ids = []
        with self._lock:
            self._model_cache[key] = (time.monotonic(), ids)
        return ids

    def _pick(self, model_id: str = ""):
        with self._lock:
            n = len(self._replicas)
            if n == 0:
                if not self._exists:
                    raise DeploymentNotFound(
                        f"no deployment named "
                        f"{self.deployment_name!r}")
                raise RuntimeError(
                    f"deployment {self.deployment_name!r} has no replicas")
            if n == 1:
                return self._replicas[0]
            a, b = random.sample(self._replicas, 2)
            limit = self._max_queries
        if model_id:
            # model multiplexing affinity (reference multiplex router):
            # prefer the candidate that already holds the model
            a_has = model_id in self._model_ids(a)
            b_has = model_id in self._model_ids(b)
            if a_has != b_has:
                return a if a_has else b
        la, lb = self._queue_len(a), self._queue_len(b)
        # avoid saturated replicas while the other candidate has room
        # (server-side max_concurrent_queries enforcement at the router,
        # reference router.py:893 candidate filtering)
        if limit > 0:
            if la >= limit and lb < limit:
                return b
            if lb >= limit and la < limit:
                return a
        return a if la <= lb else b

    def options(self, *, multiplexed_model_id: str = "",
                stream: bool = False) -> "_HandleOptions":
        """Per-call routing options (reference handle .options():
        multiplexed_model_id steers to replicas holding the model;
        stream=True returns a generator of response chunks)."""
        return _HandleOptions(self, multiplexed_model_id, stream)

    def remote(self, *args: Any, **kwargs: Any):
        return self._submit(args, kwargs, model_id="", stream=False)

    # ---- shared in-flight/probe accounting (router load estimates:
    # _submit and _submit_batch must never diverge here) -------------
    def _track_inflight(self, key: str) -> None:
        with self._lock:
            self._in_flight[key] = self._in_flight.get(key, 0) + 1
            self._probe_delta[key] = self._probe_delta.get(key, 0) + 1

    def _untrack_inflight(self, key: str) -> None:
        with self._lock:
            self._in_flight[key] = max(
                0, self._in_flight.get(key, 1) - 1)
            self._probe_delta[key] = self._probe_delta.get(key, 1) - 1

    def _submit(self, args: tuple, kwargs: Dict[str, Any], *,
                model_id: str, stream: bool):
        from ray_tpu_torch._private import spans as _spans_lib
        from ray_tpu_torch.serve import _telemetry
        t_submit = time.monotonic()
        with _spans_lib.span("serve.handle.submit",
                             deployment=self.deployment_name):
            self._refresh()
            replica = self._pick(model_id)
            key = replica._actor_id.hex()
            self._track_inflight(key)
            if stream:
                method = replica.handle_request_stream.options(
                    num_returns="streaming")
            else:
                method = replica.handle_request
            # the wall stamp rides to the replica, which records its
            # time-in-queue (submit → execution start) against it
            ref = method.remote(args, kwargs, model_id, time.time())

        def _done() -> None:
            self._untrack_inflight(key)
            # one request_seconds observation per request, handle-side:
            # covers proxy AND direct-handle traffic without double
            # counting, and a request the proxy abandoned at its
            # deadline still records its true latency
            _telemetry.observe_request(self.deployment_name,
                                       time.monotonic() - t_submit)

        # completion observer — no extra thread, no second result fetch
        import ray_tpu_torch._private.worker as worker_mod
        cw = worker_mod.global_worker().core_worker
        if stream:
            # account completion on the generator TASK's handle ref —
            # it fires when the replica finishes producing, whether or
            # not the caller ever iterates the response (an abandoned
            # stream must not inflate the replica's load counters)
            cw.add_done_callback(ref.handle, _done)
            return _StreamingResponse(ref)
        cw.add_done_callback(ref, _done)
        return ref

    def _submit_batch(self, items: List[Any]):
        """Proxy-coalesced submit: N single-positional requests as ONE
        handle_request_batch task (see proxy_fleet _Coalescer /
        Replica.handle_request_batch). Routed like any request (P2C);
        in-flight accounting counts the one task, request_seconds
        observes once per fused item on completion."""
        from ray_tpu_torch._private import spans as _spans_lib
        from ray_tpu_torch.serve import _telemetry
        t_submit = time.monotonic()
        n = len(items)
        with _spans_lib.span("serve.handle.submit",
                             deployment=self.deployment_name,
                             batch=n):
            self._refresh()
            replica = self._pick("")
            key = replica._actor_id.hex()
            self._track_inflight(key)
            ref = replica.handle_request_batch.remote(
                list(items), "", time.time())

        def _done() -> None:
            self._untrack_inflight(key)
            dur = time.monotonic() - t_submit
            for _ in range(n):
                _telemetry.observe_request(self.deployment_name, dur)

        import ray_tpu_torch._private.worker as worker_mod
        cw = worker_mod.global_worker().core_worker
        cw.add_done_callback(ref, _done)
        return ref


def _listen_loop(handle_ref) -> None:
    """Long-poll loop for one DeploymentHandle (held by weakref): block
    in the controller until the deployment's snapshot advances, apply
    the pushed routing info, re-arm. Exits when the handle is collected
    or the cluster goes away repeatedly."""
    version = 0
    failures = 0
    while True:
        handle = handle_ref()
        if handle is None:
            return
        controller = handle._controller
        name = handle.deployment_name
        del handle  # don't pin the handle while parked in the long poll
        try:
            # server-side park (10s) stays well under the client timeout
            # (40s) so a call queued behind a full 'control' group still
            # returns in time instead of feeding the failure counter
            # long-poll: ONE in-flight call per loop turn is the design
            out = ray_tpu_torch.get(  # graftlint: disable=RT002
                controller.listen_for_change.remote({name: version}, 10.0),
                timeout=40)
            failures = 0
        except Exception:  # noqa: BLE001 — controller gone/busy
            failures += 1
            if failures >= 5:
                # give up, but let a later _refresh re-arm a fresh
                # listener (e.g. after a controller restart)
                handle = handle_ref()
                if handle is not None:
                    handle._listener_started = False
                return
            time.sleep(1.0)
            continue
        if not out:
            continue  # timeout: re-arm
        handle = handle_ref()
        if handle is None:
            return
        version, info = out[name]
        handle._apply_routing_info(info)
        handle._last_refresh = time.monotonic()


class _HandleOptions:
    """Per-call view over a DeploymentHandle (reference handle
    .options(...))."""

    def __init__(self, handle: DeploymentHandle, model_id: str,
                 stream: bool):
        self._handle = handle
        self._model_id = model_id
        self._stream = stream

    def remote(self, *args: Any, **kwargs: Any):
        return self._handle._submit(args, kwargs,
                                    model_id=self._model_id,
                                    stream=self._stream)


class _StreamingResponse:
    """Iterates a streaming deployment call's chunks as values
    (reference serve streaming responses: the proxy iterates the
    ObjectRefGenerator and yields chunk bytes)."""

    def __init__(self, gen):
        self._gen = gen

    def __iter__(self):
        from ray_tpu_torch._private.config import Config
        for ref in self._gen:
            # streaming: chunks are consumed in order as they land;
            # bounded per chunk — a wedged generator must fail the
            # consumer instead of parking it forever (RT017)
            yield ray_tpu_torch.get(  # graftlint: disable=RT002
                ref, timeout=Config.serve_request_timeout_s)


def run(app: Any, *, name: Optional[str] = None) -> DeploymentHandle:
    """Deploy and wait ready (reference serve.run)."""
    if isinstance(app, Deployment):
        app = app.bind()
    d = app.deployment
    controller = _get_or_create_controller()
    import cloudpickle
    # proxy-side coalescing eligibility: a @serve.batch-decorated
    # __call__ means single-positional ingress requests can fuse into
    # one replica submit (proxy_fleet _Coalescer)
    coalesce = bool(getattr(
        getattr(d.func_or_class, "__call__", None),
        "_serve_batch", False))
    ray_tpu_torch.get(controller.deploy.remote(
        name=name or d.name,
        target_blob=cloudpickle.dumps(d.func_or_class),
        init_args=app.init_args, init_kwargs=app.init_kwargs,
        num_replicas=d.num_replicas,
        max_concurrent_queries=d.max_concurrent_queries,
        ray_actor_options=d.ray_actor_options,
        autoscaling=d.autoscaling_config,
        max_queued_requests=d.max_queued_requests,
        rate_limit_rps=d.rate_limit_rps,
        coalesce=coalesce), timeout=300)
    return DeploymentHandle(name or d.name, controller)


def get_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def delete(name: str) -> None:
    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=120)


def shutdown() -> None:
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                       namespace=_NAMESPACE)
    except Exception:  # noqa: BLE001
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=120)
    except Exception:  # noqa: BLE001 - wedged; the kill below is the backstop
        pass
    try:
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001 - controller already dead
        pass


def _local_fleet_proxy(status: Dict[str, Any]) -> Any:
    """The calling node's proxy actor out of a fleet status (falls back
    to any healthy proxy — a driver on a proxyless node still gets an
    ingress handle)."""
    from ray_tpu_torch.serve._private.proxy_fleet.fleet import (
        PROXY_NAME_PREFIX)
    my_node = ray_tpu_torch.get_runtime_context().get_node_id()
    proxies = status.get("proxies", [])
    # prefer local, healthy, NOT-draining (a mid-roll fleet: the
    # draining proxy still serves, but its replacement is the one
    # whose port survives this round)
    ordered = sorted(proxies,
                     key=lambda p: (p["node_id"] != my_node,
                                    bool(p.get("draining", False)),
                                    not p.get("healthy", False)))
    for p in ordered:
        try:
            return ray_tpu_torch.get_actor(
                f"{PROXY_NAME_PREFIX}{p['node_id'][:12]}",
                namespace=_NAMESPACE)
        except Exception:  # noqa: BLE001 - raced a dying proxy
            continue
    raise RuntimeError(f"ingress fleet started no proxies: {status}")


def start_http(port: int = 8000,
               request_timeout_s: Optional[float] = None) -> Any:
    """Start the ingress fleet's HTTP side (reference serve.start +
    proxy_state): ONE asyncio proxy per alive node, with admission
    control, load shedding, and drain-safe rolling updates (README
    "Serve at scale"). POST/GET /<deployment> with a JSON body calls
    the deployment and returns the JSON result; `request_timeout_s`
    bounds each request's handle wait (default
    Config.serve_request_timeout_s; timeouts surface as 504). To serve
    gRPC off the same per-node event loops, arm the fleet with
    serve.start_fleet(grpc_port=...); serve.start_grpc remains the
    LEGACY standalone gRPC actor.

    Returns the LOCAL node's proxy actor (API-compatible with the old
    single threading proxy: .ready / .stop / .requests_snapshot);
    fleet-wide state lives behind serve.fleet_status(). Config changes
    roll the fleet node-by-node (drain-first) on subsequent reconcile
    rounds. Proxies self-register as named actors
    (SERVE_PROXY_FLEET_<node>, namespace "serve") so the
    request-telemetry query plane can enumerate them."""
    controller = _get_or_create_controller()
    last: Optional[Exception] = None
    for _attempt in range(3):
        # bounded 3-attempt name-release retry, one call per attempt —
        # not a serialization of independent work
        status = ray_tpu_torch.get(  # graftlint: disable=RT002
            controller.start_proxy_fleet.remote(
                http_port=port, request_timeout_s=request_timeout_s),
            timeout=120)
        try:
            return _local_fleet_proxy(status)
        except RuntimeError as e:
            # a just-killed predecessor can hold the actor name for a
            # beat; the next reconcile round starts the replacement
            last = e
            time.sleep(1.0)
    raise last


def start_fleet(http_port: Optional[int] = None,
                grpc_port: Optional[int] = None,
                request_timeout_s: Optional[float] = None
                ) -> Dict[str, Any]:
    """Arm (or reconfigure) the whole ingress fleet explicitly — the
    superset of start_http that also serves gRPC from each node's
    event loop (`grpc_port`; shed → RESOURCE_EXHAUSTED with a
    retry-after metadata hint). Every parameter is keep-if-None, so
    `serve.start_fleet(grpc_port=9001)` adds gRPC WITHOUT rolling the
    armed HTTP port. Returns the fleet status (per-node proxies with
    bound ports). A changed config rolls proxies node-by-node,
    drain-first."""
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.start_proxy_fleet.remote(
        http_port=http_port, grpc_port=grpc_port,
        request_timeout_s=request_timeout_s), timeout=120)


def fleet_status() -> Dict[str, Any]:
    """Ingress fleet state: per-node proxies, ports, health, drain
    flags (CLI: `ray_tpu serve fleet`)."""
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.fleet_status.remote(), timeout=30)


def drain_proxy(node_id: str) -> bool:
    """Drain one node's ingress proxy (stop accepting → finish
    in-flight → deregister) ahead of node removal. Returns False if the
    node has no proxy."""
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.drain_proxy.remote(node_id),
                       timeout=120)
