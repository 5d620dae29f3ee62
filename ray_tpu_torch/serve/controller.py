"""Serve controller: reconciles deployment state to replica actors.

reference parity: serve/_private/controller.py:87 (ServeController actor)
+ deployment_state.py:1149 (DeploymentState reconciliation: target
replicas vs running replicas, health checks, replacements) +
autoscaling_policy.py (queue-depth driven scaling between min/max).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional
from ray_tpu_torch.util.locks import TracedLock

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"


def replica_ping(replica) -> bool:
    import ray_tpu_torch
    try:
        return ray_tpu_torch.get(replica.ping.remote(), timeout=10) == "pong"
    except Exception:  # noqa: BLE001
        return False


def _control_group(fn):
    """Tag a Replica method onto the 'control' concurrency group (the
    plain ray_tpu_torch.method decorator, applied without importing ray_tpu at
    module import time)."""
    fn.__ray_tpu_method_options__ = {"concurrency_group": "control"}
    return fn


# current request's multiplexed model id (reference
# serve/_private/replica.py request context + serve.api
# get_multiplexed_model_id)
_current_model_id = threading.local()


def get_multiplexed_model_id() -> str:
    return getattr(_current_model_id, "value", "")


class _MultiplexWrapper:
    """Per-replica LRU of loaded models behind a user loader fn
    (reference serve/api.py @serve.multiplexed + multiplex.py
    _ModelMultiplexWrapper)."""

    def __init__(self, loader, max_num_models_per_replica: int = 3):
        self.loader = loader
        self.max_models = max(1, max_num_models_per_replica)
        self.models: Dict[str, Any] = {}   # insertion order = LRU
        self._loading: Dict[str, threading.Event] = {}
        self._lock = TracedLock("serve_model_cache")

    def load(self, owner, model_id: str):
        # per-model-id load serialization: concurrent requests for the
        # same missing model must not both run the (possibly HBM-
        # hungry) loader — the reference wrapper serializes loads too.
        # Waiters loop: on wake they re-check the cache (the loader
        # publishes the model BEFORE setting the gate), and if the
        # loader failed exactly one waiter becomes the next loader.
        while True:
            with self._lock:
                if model_id in self.models:
                    model = self.models.pop(model_id)
                    self.models[model_id] = model  # refresh LRU position
                    return model
                gate = self._loading.get(model_id)
                if gate is None:
                    gate = threading.Event()
                    self._loading[model_id] = gate
                    break  # we are the loader
            gate.wait(timeout=600)
        try:
            model = self.loader(owner, model_id)
            with self._lock:
                self.models[model_id] = model
                while len(self.models) > self.max_models:
                    evicted_id = next(iter(self.models))
                    self.models.pop(evicted_id)
                    logger.info(
                        "multiplex: evicted model %s (dropped; "
                        "resources release with its refcount)",
                        evicted_id)
            return model
        finally:
            # publish-then-release ordering: models[...] is already set
            # (on success) when waiters wake
            with self._lock:
                self._loading.pop(model_id, None)
            gate.set()

    def loaded_ids(self) -> List[str]:
        with self._lock:
            return list(self.models)


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator for a deployment method that loads a model by id; the
    wrapper caches up to max_num_models_per_replica loaded models per
    replica with LRU eviction (reference serve.multiplexed)."""

    def wrap(fn):
        state_attr = f"__mux_{fn.__name__}"

        def getter(self, model_id: str):
            mux = getattr(self, state_attr, None)
            if mux is None:
                mux = _MultiplexWrapper(fn, max_num_models_per_replica)
                setattr(self, state_attr, mux)
            return mux.load(self, model_id)

        getter.__mux_marker__ = True
        getter.__wrapped__ = fn
        return getter

    if _fn is not None:
        return wrap(_fn)
    return wrap


class Replica:
    """The per-replica actor: hosts one instance of the user deployment
    (reference serve/_private/replica.py). Request telemetry (README
    "Serve request telemetry"): each request records its time-in-queue
    (the handle's submit wall stamp → execution start, into
    ``ray_tpu_serve_queue_seconds{deployment}`` + a span) and its
    execution as a ``serve.replica.execute`` span — both carry the
    ingress trace id, which the executor already restored from the task
    spec before this method runs."""

    def __init__(self, target_blob: bytes, init_args: tuple,
                 init_kwargs: Dict[str, Any],
                 deployment_name: str = ""):
        import cloudpickle
        target = cloudpickle.loads(target_blob)
        if isinstance(target, type):
            self._callable = target(*init_args, **init_kwargs)
        else:
            self._callable = target
        self.deployment_name = deployment_name
        self._in_flight = 0
        self._total = 0
        self._lock = TracedLock("serve_replica")
        from ray_tpu_torch.serve import _telemetry
        _telemetry.register_replica(self)

    @_control_group
    def ping(self) -> str:
        return "pong"

    def ongoing_requests(self) -> int:
        """Queued + executing on this worker's default executor group —
        the harvest-time replica queue-depth gauge reads this (NOT an
        actor call: runs in-process from the metrics sampler)."""
        from ray_tpu_torch._private import worker as worker_mod
        w = worker_mod.global_worker_or_none()
        ex = w.core_worker.executor if w is not None else None
        return ex.queue_depth("") if ex is not None else 0

    def _record_queue_time(self, submit_ts) -> None:
        if not submit_ts:
            return
        import time as _time

        from ray_tpu_torch._private import spans as spans_lib
        from ray_tpu_torch.serve import _telemetry
        # cross-process interval: the handle stamped WALL time (monotonic
        # clocks are per-process); same-host skew is negligible next to
        # queueing delay  # graftlint: disable=RT010
        queue_s = max(0.0, _time.time() - submit_ts)
        _telemetry.observe_queue(self.deployment_name, queue_s)
        spans_lib.complete("serve.replica.queue", queue_s,
                           deployment=self.deployment_name)

    def handle_request(self, args: tuple, kwargs: Dict[str, Any],
                       model_id: str = "", submit_ts=None) -> Any:
        from ray_tpu_torch._private import spans as spans_lib
        self._record_queue_time(submit_ts)
        with self._lock:
            self._in_flight += 1
            self._total += 1
        _current_model_id.value = model_id
        try:
            with spans_lib.span("serve.replica.execute",
                                deployment=self.deployment_name):
                fn = self._callable
                if not callable(fn):
                    raise TypeError(
                        f"deployment target {fn!r} is not callable")
                return fn(*args, **kwargs)
        finally:
            _current_model_id.value = ""
            with self._lock:
                self._in_flight -= 1

    def handle_request_batch(self, requests: List[Any],
                             model_id: str = "",
                             submit_ts=None) -> List[tuple]:
        """Proxy-coalesced execution: `requests` is a list of single
        positional args fused by an ingress proxy (proxy_fleet
        _Coalescer) into ONE task submit. A @serve.batch-decorated
        __call__ gets every item enqueued BEFORE any result is awaited,
        so the whole proxy batch lands in one fused forward pass;
        plain callables run the items in order (still one task's
        overhead instead of N). Returns [(ok, result-or-error), ...] —
        per-item errors must not fail the co-batched strangers."""
        from ray_tpu_torch._private import spans as spans_lib
        from ray_tpu_torch._private.config import Config
        self._record_queue_time(submit_ts)
        with self._lock:
            self._in_flight += 1
            self._total += len(requests)
        _current_model_id.value = model_id
        out: List[tuple] = []
        try:
            with spans_lib.span("serve.replica.execute",
                                deployment=self.deployment_name,
                                batch=len(requests)):
                fn = self._callable
                if not callable(fn):
                    raise TypeError(
                        f"deployment target {fn!r} is not callable")
                # class deployments only: the @serve.batch wrapper is
                # the class's __call__ (function deployments can't
                # batch — the wrapper needs an owner for its queue)
                meth = getattr(type(fn), "__call__", None)
                submit_many = getattr(meth, "_serve_batch_submit_many",
                                      None)
                if submit_many is not None:
                    futs = submit_many(fn, list(requests))
                    # ONE shared deadline for the whole batch: a
                    # wedged handler costs one timeout, not N of them
                    # serially (which would pin this executor slot —
                    # and block Replica.drain — for N x timeout)
                    deadline = time.monotonic() \
                        + Config.serve_request_timeout_s
                    for f in futs:
                        try:
                            out.append((True, f.result(
                                timeout=max(0.0, deadline
                                            - time.monotonic()))))
                        except Exception as e:  # noqa: BLE001
                            out.append((False,
                                        f"{type(e).__name__}: {e}"))
                else:
                    for item in requests:
                        try:
                            out.append((True, fn(item)))
                        except Exception as e:  # noqa: BLE001
                            out.append((False,
                                        f"{type(e).__name__}: {e}"))
            return out
        finally:
            _current_model_id.value = ""
            with self._lock:
                self._in_flight -= 1

    @_control_group
    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful-shutdown gate (rolling updates): poll until every
        queued + executing request on the default group has finished.
        Runs on the control group so it can observe the default group
        draining; new work stops arriving because the controller bumped
        the routing snapshot away from this replica first."""
        import time as _time
        deadline = _time.monotonic() + timeout_s
        while _time.monotonic() < deadline:
            if self.ongoing_requests() == 0:
                with self._lock:
                    if self._in_flight == 0:
                        return True
            _time.sleep(0.05)
        return False

    def handle_request_stream(self, args: tuple,
                              kwargs: Dict[str, Any],
                              model_id: str = "", submit_ts=None):
        """Generator variant (reference serve streaming responses /
        proxy.py:556): the deployment callable returns an iterable and
        chunks stream back as they are produced (num_returns=
        "streaming" on the caller side)."""
        from ray_tpu_torch._private import spans as spans_lib
        self._record_queue_time(submit_ts)
        with self._lock:
            self._in_flight += 1
            self._total += 1
        _current_model_id.value = model_id
        try:
            with spans_lib.span("serve.replica.execute",
                                deployment=self.deployment_name,
                                stream=True):
                fn = self._callable
                out = fn(*args, **kwargs)
                for chunk in out:
                    yield chunk
        finally:
            _current_model_id.value = ""
            with self._lock:
                self._in_flight -= 1

    @_control_group
    def multiplexed_model_ids(self) -> List[str]:
        """Model ids loaded by any @multiplexed loader on the target
        (router affinity signal; reference multiplex router prefers
        replicas that already hold the model)."""
        out: List[str] = []
        target = self._callable
        for v in vars(target).values():
            if isinstance(v, _MultiplexWrapper):
                out.extend(v.loaded_ids())
        return out

    @_control_group
    def queue_len(self) -> int:
        """Server-side ongoing count: requests executing + waiting in
        this replica's default-group queue. Runs on the dedicated
        "control" concurrency group so it answers instantly even when
        every handle_request slot is saturated (reference: replica
        queue-length probe consumed by router.py:893
        PowerOfTwoChoicesReplicaScheduler)."""
        import ray_tpu_torch
        return ray_tpu_torch.get_runtime_context().get_task_queue_depth("")

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"in_flight": self._in_flight, "total": self._total}


@dataclass
class _DeploymentState:
    name: str
    target_blob: bytes
    init_args: tuple
    init_kwargs: Dict[str, Any]
    target_replicas: int
    max_concurrent_queries: int
    ray_actor_options: Dict[str, Any]
    autoscaling: Optional[Any] = None
    # ingress admission control (proxy_fleet/admission.py): queued
    # requests admitted beyond replica capacity (-1 = config default)
    # and a per-proxy token-bucket rate limit (0 = unlimited)
    max_queued_requests: int = -1
    rate_limit_rps: float = 0.0
    # proxy-side request coalescing: True when the deployment's
    # __call__ is @serve.batch-decorated (detected at serve.run time)
    coalesce: bool = False
    replicas: List[Any] = field(default_factory=list)
    deleted: bool = False
    # sustained-condition tracking for autoscaling delays
    high_since: Optional[float] = None
    low_since: Optional[float] = None
    # serializes reconciliation per deployment: deploy()/delete() on RPC
    # threads race the background reconcile loop otherwise, double-
    # starting replicas and orphaning the losers
    op_lock: threading.Lock = field(default_factory=threading.Lock)


class ServeController:
    """Named actor owning all deployment state; a reconcile thread keeps
    running replicas == target and applies autoscaling decisions."""

    RECONCILE_PERIOD_S = 1.0

    def __init__(self) -> None:
        from ray_tpu_torch.serve._private.proxy_fleet.fleet import (
            ProxyFleetManager)
        self._deployments: Dict[str, _DeploymentState] = {}
        self._lock = TracedLock("serve_controller")
        self._stop = threading.Event()
        # long-poll state (reference serve/_private/long_poll.py:30
        # LongPollHost): per-deployment snapshot ids; listeners block on
        # the condition until a watched id advances.
        self._lp_cond = threading.Condition()
        self._snapshots: Dict[str, int] = {}
        # ingress fleet (proxy_fleet/fleet.py): reconciled on its OWN
        # thread once start_proxy_fleet arms it — a proxy drain (up to
        # serve_drain_timeout_s) must never stall replica repair or
        # autoscaling on the deployment loop
        self._fleet = ProxyFleetManager()
        threading.Thread(target=self._reconcile_loop, daemon=True,
                         name="serve-reconcile").start()
        threading.Thread(target=self._fleet_loop, daemon=True,
                         name="serve-fleet-reconcile").start()

    # ---- ingress fleet ----------------------------------------------

    def _alive_node_ids(self) -> List[str]:
        from ray_tpu_torch._private import worker as worker_mod
        gcs = worker_mod.global_worker().core_worker._gcs
        return [n.node_id.hex() for n in gcs.call("get_all_nodes")
                if n.alive]

    def start_proxy_fleet(self, http_port: Optional[int] = None,
                          grpc_port: Optional[int] = None,
                          request_timeout_s: Optional[float] = None
                          ) -> Dict[str, Any]:
        """Arm (or reconfigure) the ingress fleet and reconcile it NOW
        so the caller gets live endpoints back. Parameters are
        keep-if-None; a changed config rolls proxies node-by-node on
        subsequent reconcile rounds."""
        self._fleet.ensure(http_port=http_port, grpc_port=grpc_port,
                           request_timeout_s=request_timeout_s)
        self._fleet.reconcile(self._alive_node_ids())
        return self._fleet.status()

    def fleet_status(self) -> Dict[str, Any]:
        return self._fleet.status()

    def drain_proxy(self, node_id: str) -> bool:
        """Drain + deregister one node's proxy (node-removal path)."""
        return self._fleet.drain_node(node_id)

    def stop_proxy_fleet(self) -> None:
        self._fleet.stop_all()

    # ---- long-poll push ---------------------------------------------

    def _bump_snapshot(self, name: str) -> None:
        with self._lp_cond:
            self._snapshots[name] = self._snapshots.get(name, 0) + 1
            self._lp_cond.notify_all()

    @_control_group
    def listen_for_change(self, keys: Dict[str, int],
                          timeout_s: float = 30.0) -> Dict[str, Any]:
        """Block until any watched deployment's snapshot id advances past
        the caller's, then return {name: (new_id, routing_info)}; {} on
        timeout (the caller re-arms). This is the push channel handles
        use instead of polling get_routing_info (reference
        long_poll.py:30 LongPollHost.listen_for_change). Runs on the
        'control' concurrency group so armed listeners never starve
        deploy/delete calls."""
        deadline = time.monotonic() + min(timeout_s, 60.0)
        while True:
            with self._lp_cond:
                changed = {k: self._snapshots.get(k, 0) for k in keys
                           if self._snapshots.get(k, 0) > keys[k]}
                if not changed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return {}
                    self._lp_cond.wait(remaining)
                    continue
            # build result outside the condition (get_routing_info takes
            # the state lock; never nest it under _lp_cond)
            return {k: (v, self.get_routing_info(k))
                    for k, v in changed.items()}

    # ---- API --------------------------------------------------------

    def deploy(self, name: str, target_blob: bytes, init_args: tuple,
               init_kwargs: Dict[str, Any], num_replicas: int,
               max_concurrent_queries: int,
               ray_actor_options: Dict[str, Any],
               autoscaling: Optional[Any] = None,
               max_queued_requests: int = -1,
               rate_limit_rps: float = 0.0,
               coalesce: bool = False) -> None:
        with self._lock:
            old = self._deployments.get(name)
            state = _DeploymentState(
                name=name, target_blob=target_blob, init_args=init_args,
                init_kwargs=init_kwargs, target_replicas=num_replicas,
                max_concurrent_queries=max_concurrent_queries,
                ray_actor_options=dict(ray_actor_options),
                autoscaling=autoscaling,
                max_queued_requests=max_queued_requests,
                rate_limit_rps=rate_limit_rps, coalesce=coalesce)
            self._deployments[name] = state
        # Rolling update, new-first (reference deployment_state rolling
        # replace): start the NEW replica set, publish it (snapshot
        # bump pushes every handle onto the new set), and only then
        # drain + stop the old one — in-flight requests on old replicas
        # finish instead of dying with the actor, so a redeploy under
        # load surfaces zero 5xx.
        if old is not None:
            old.deleted = True
        self._reconcile_one(state)
        self._bump_snapshot(name)
        if old is not None:
            with old.op_lock:
                self._drain_replicas(old.replicas)
                self._stop_replicas(old.replicas)
                old.replicas = []

    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            state = self._deployments.get(name)
            return list(state.replicas) if state else []

    def get_routing_info(self, name: str) -> Dict[str, Any]:
        """Replica set + limits the router needs (reference: the long
        poll updates handles receive from the controller). Carries the
        deployment's snapshot_id so handles can discard stale responses
        (a slow poll must not overwrite a newer pushed set)."""
        with self._lp_cond:
            snap = self._snapshots.get(name, 0)
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                # exists=False routes the handle's empty-replica failure
                # to DeploymentNotFound (ingress 404), distinct from a
                # known deployment transiently at zero replicas
                return {"replicas": [], "max_concurrent_queries": 0,
                        "snapshot_id": snap, "exists": False}
            return {"replicas": list(state.replicas),
                    "max_concurrent_queries": state.max_concurrent_queries,
                    "snapshot_id": snap, "exists": True,
                    # ingress admission + coalescing hints (the proxy
                    # fleet derives per-deployment limits from these)
                    "max_queued_requests": state.max_queued_requests,
                    "rate_limit_rps": state.rate_limit_rps,
                    "coalesce": state.coalesce}

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {n: {"target_replicas": s.target_replicas,
                        "running_replicas": len(s.replicas)}
                    for n, s in self._deployments.items()}

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            state = self._deployments.pop(name, None)
        if state is not None:
            state.deleted = True
            with state.op_lock:  # wait out any in-flight reconcile
                self._stop_replicas(state.replicas)
                state.replicas = []
            self._bump_snapshot(name)

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._fleet.stop_all()
        except Exception:  # noqa: BLE001 - proxies die with the cluster
            logger.exception("proxy fleet stop failed during shutdown")
        with self._lock:
            states = list(self._deployments.values())
            self._deployments.clear()
        for s in states:
            self._stop_replicas(s.replicas)

    # ---- reconciliation --------------------------------------------

    def _start_replica(self, state: _DeploymentState):
        import ray_tpu_torch
        cls = ray_tpu_torch.remote(Replica)
        opts: Dict[str, Any] = {"num_cpus": 0.1}
        opts.update(state.ray_actor_options)
        opts["max_concurrency"] = state.max_concurrent_queries
        # control group: health pings + queue-length probes stay
        # responsive while all request slots are saturated (merged so
        # user-declared groups in ray_actor_options survive)
        opts["concurrency_groups"] = {
            **(opts.get("concurrency_groups") or {}), "control": 2}
        return cls.options(**opts).remote(
            state.target_blob, state.init_args, state.init_kwargs,
            deployment_name=state.name)

    def _stop_replicas(self, replicas: List[Any]) -> None:
        import ray_tpu_torch
        for r in replicas:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001 - replica already dead
                pass

    def _drain_replicas(self, replicas: List[Any]) -> None:
        """Wait (bounded) for every replica's queued + executing
        requests to finish before it is stopped — the rolling-update
        half of the zero-5xx contract. One batched wait bounds the
        whole drain instead of timeout x replicas."""
        import ray_tpu_torch
        from ray_tpu_torch._private.config import Config
        budget = Config.serve_drain_timeout_s
        drains = []
        for r in replicas:
            try:
                drains.append(r.drain.remote(budget))
            except Exception:  # noqa: BLE001 — dead replica has
                pass           # nothing in flight to wait for
        if drains:
            ray_tpu_torch.wait(drains, num_returns=len(drains),
                         timeout=budget + 15)

    def _reconcile_one(self, state: _DeploymentState) -> None:
        import ray_tpu_torch
        with state.op_lock:
            if state.deleted:
                return
            # replace dead replicas (reference deployment_state checks)
            with self._lock:
                replicas = list(state.replicas)
            alive = []
            for r in replicas:
                if replica_ping(r):
                    alive.append(r)
            while len(alive) < state.target_replicas:
                alive.append(self._start_replica(state))
            extra = alive[state.target_replicas:]
            alive = alive[:state.target_replicas]
            self._stop_replicas(extra)
            # wait for newly started replicas to answer — one batched
            # wait bounds the whole rollout by 120s instead of 120s per
            # replica (found by graftlint RT002); submits stay guarded
            # per replica so one stuck/full replica can't fail deploy()
            pings = []
            for r in alive:
                try:
                    pings.append(r.ping.remote())
                except Exception:  # noqa: BLE001 — e.g. pending-calls full
                    pass
            if pings:
                ray_tpu_torch.wait(pings, num_returns=len(pings), timeout=120)
            with self._lock:
                if state.deleted:
                    # deleted while we were reconciling: the DELETER
                    # (redeploy/delete_deployment) owns these replicas
                    # — it drains then stops them under op_lock after
                    # us. Stopping here would skip the drain and kill
                    # in-flight requests mid-rolling-update.
                    state.replicas = alive
                    changed = False
                else:
                    changed = [id(r) for r in state.replicas] != \
                        [id(r) for r in alive]
                    state.replicas = alive
        if changed:  # replica set moved: push to long-poll listeners
            self._bump_snapshot(state.name)

    def _autoscale_one(self, state: _DeploymentState) -> None:
        import ray_tpu_torch
        cfg = state.autoscaling
        if cfg is None or not state.replicas:
            return
        try:
            stats = ray_tpu_torch.get(
                [r.stats.remote() for r in state.replicas], timeout=30)
        except Exception:  # noqa: BLE001
            return
        avg_in_flight = sum(s["in_flight"] for s in stats) / len(stats)
        now = time.monotonic()
        # Sustained-condition delays (reference autoscaling_policy): the
        # breach must HOLD for the delay window, not merely postdate the
        # previous scaling event — one bursty sample must not scale.
        high = avg_in_flight > cfg.target_ongoing_requests
        low = avg_in_flight < cfg.target_ongoing_requests / 2
        state.high_since = (state.high_since or now) if high else None
        state.low_since = (state.low_since or now) if low else None
        if high and state.target_replicas < cfg.max_replicas and \
                now - state.high_since >= cfg.upscale_delay_s:
            state.target_replicas += 1
            state.high_since = now
            logger.info("serve: scaling %s up to %d (avg in-flight %.1f)",
                        state.name, state.target_replicas, avg_in_flight)
        elif low and state.target_replicas > cfg.min_replicas and \
                now - state.low_since >= cfg.downscale_delay_s:
            state.target_replicas -= 1
            state.low_since = now
            logger.info("serve: scaling %s down to %d",
                        state.name, state.target_replicas)

    def _reconcile_loop(self) -> None:
        while not self._stop.wait(self.RECONCILE_PERIOD_S):
            with self._lock:
                states = list(self._deployments.values())
            for state in states:
                try:
                    self._autoscale_one(state)
                    self._reconcile_one(state)
                except Exception:  # noqa: BLE001
                    logger.exception("serve reconcile failed for %s",
                                     state.name)

    def _fleet_loop(self) -> None:
        while not self._stop.wait(self.RECONCILE_PERIOD_S):
            if not self._fleet.enabled:
                continue  # don't pay a GCS node-list RPC per second
            try:          # for a fleet nobody armed
                self._fleet.reconcile(self._alive_node_ids())
            except Exception:  # noqa: BLE001
                logger.exception("serve fleet reconcile failed")
