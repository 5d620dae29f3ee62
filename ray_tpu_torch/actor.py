"""ActorClass / ActorHandle / ActorMethod.

reference parity: python/ray/actor.py — ActorClass (:425), ActorClass._remote
(:708), ActorHandle (:1067), ActorMethod (:107). Actor-only options per
_private/ray_option_utils.py: max_restarts, max_task_retries,
max_concurrency, lifetime, name, namespace, get_if_exists, max_pending_calls,
concurrency_groups.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import ActorID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.state import (DefaultSchedulingStrategy, TaskSpec,
                                    TaskType)
from ray_tpu_torch.remote_function import (build_resources, pack_args,
                                     validate_runtime_env, _extract_pg)

_ACTOR_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "resources", "memory", "name",
    "namespace", "lifetime", "max_restarts", "max_task_retries",
    "max_concurrency", "max_pending_calls", "get_if_exists",
    "scheduling_strategy", "runtime_env", "accelerator_type",
    "placement_group", "placement_group_bundle_index",
    "placement_group_capture_child_tasks", "object_store_memory",
    "concurrency_groups", "_metadata",
}


def method(**options: Any):
    """@ray_tpu_torch.method decorator: per-method defaults on actor classes
    (reference ray.method — num_returns, concurrency_group)."""
    allowed = {"num_returns", "concurrency_group"}
    bad = set(options) - allowed
    if bad:
        raise ValueError(f"invalid method options: {sorted(bad)}")

    def deco(fn):
        fn.__ray_tpu_method_options__ = options
        return fn

    return deco


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1, concurrency_group: str = ""):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(self, **kwargs: Any) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._method_name,
            kwargs.get("num_returns", self._num_returns),
            kwargs.get("concurrency_group", self._concurrency_group))

    def remote(self, *args: Any, **kwargs: Any) -> Any:
        return self._handle._submit(self._method_name, args, kwargs,
                                    self._num_returns,
                                    self._concurrency_group)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise TypeError(
            f"actor method '{self._method_name}' cannot be called directly; "
            f"use .remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str,
                 method_names: List[str], fn_key: str,
                 method_options: Optional[Dict[str, Dict[str, Any]]]
                 = None,
                 concurrency_groups: Optional[List[str]] = None,
                 max_pending_calls: int = -1):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_names = list(method_names)
        self._fn_key = fn_key
        self._method_options = dict(method_options or {})
        self._concurrency_groups = list(concurrency_groups or [])
        self._max_pending_calls = int(max_pending_calls)
        w = worker_mod.global_worker_or_none()
        if w is not None:
            w.core_worker.attach_actor(actor_id)

    @property
    def _actor_id_hex(self) -> str:
        return self._actor_id.hex()

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._method_names:
            raise AttributeError(
                f"actor {self._class_name} has no method '{name}'")
        opts = self._method_options.get(name, {})
        method = ActorMethod(self, name,
                             opts.get("num_returns", 1),
                             opts.get("concurrency_group", ""))
        # cache on the instance: __getattr__ only fires on misses, so
        # `handle.m.remote()` in a hot loop builds the method once
        self.__dict__[name] = method
        return method

    def _submit(self, method_name: str, args: tuple, kwargs: dict,
                num_returns: int, concurrency_group: str = "") -> Any:
        if concurrency_group and \
                concurrency_group not in self._concurrency_groups:
            # reference raises too — a silent default-pool fallback
            # would lose the isolation the caller asked for
            raise ValueError(
                f"actor {self._class_name} has no concurrency group "
                f"{concurrency_group!r}; declared: "
                f"{self._concurrency_groups}")
        w = worker_mod.global_worker()
        args_blob, arg_refs = pack_args(args, kwargs)
        # generator actor methods (reference StreamingObjectRefGenerator
        # works for actor tasks too, _raylet.pyx:269)
        dynamic = num_returns in ("dynamic", "streaming")
        refs = w.core_worker.submit_actor_task(
            self._actor_id, method_name, self._fn_key, args_blob, arg_refs,
            1 if dynamic else num_returns,
            concurrency_group=concurrency_group,
            max_pending_calls=self._max_pending_calls,
            dynamic_returns=dynamic)
        if dynamic and num_returns == "streaming":
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator
            return ObjectRefGenerator(refs[0])
        if dynamic or num_returns == 1:
            return refs[0]
        return refs

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name,
                              self._method_names, self._fn_key,
                              self._method_options,
                              self._concurrency_groups,
                              self._max_pending_calls))


class ActorClass:
    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        bad = set(self._options) - _ACTOR_OPTIONS
        if bad:
            raise ValueError(f"invalid actor options: {sorted(bad)}")
        self._fn_key: Optional[str] = None
        self._client_ac = None  # cached thin-client wrapper (ray:// mode)

    def options(self, **kwargs: Any) -> "ActorClass":
        ac = ActorClass(self._cls, {**self._options, **kwargs})
        ac._fn_key = self._fn_key
        return ac

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise TypeError(
            f"actor class '{self._cls.__name__}' cannot be instantiated "
            f"directly; use .remote()")

    def _method_names(self) -> List[str]:
        return [m for m in dir(self._cls)
                if not m.startswith("_") and callable(getattr(self._cls, m))]

    def _method_options(self) -> Dict[str, Dict[str, Any]]:
        """@ray_tpu_torch.method(...) tags per method name."""
        out: Dict[str, Dict[str, Any]] = {}
        for m in self._method_names():
            tags = getattr(getattr(self._cls, m),
                           "__ray_tpu_method_options__", None)
            if tags:
                out[m] = dict(tags)
        return out

    def _concurrency_groups(self, method_opts: Dict[str, Dict[str, Any]]
                            ) -> Optional[Dict[str, int]]:
        groups = self._options.get("concurrency_groups")
        if groups is not None and (
                not isinstance(groups, dict)
                or not all(isinstance(k, str) and k
                           for k in groups)
                or not all(isinstance(v, int) and v >= 1
                           for v in groups.values())):
            raise ValueError(
                "concurrency_groups must be {non-empty group name: "
                "max_concurrency >= 1}, got " + repr(groups))
        # every method-tagged group must be declared
        declared = set(groups or {})
        for m, tags in method_opts.items():
            g = tags.get("concurrency_group")
            if g and g not in declared:
                raise ValueError(
                    f"method {m!r} uses undeclared concurrency group "
                    f"{g!r}; declare it in "
                    f"options(concurrency_groups={{...}})")
        return dict(groups) if groups else None

    def bind(self, *args: Any, **kwargs: Any):
        """Lazy graph node (reference dag/class_node.py)."""
        raise NotImplementedError(
            "ray_tpu_torch.dag is not ported yet (ROADMAP.md, Queue 1: "
            "dag)")

    def _default_concurrency(self) -> int:
        """Async actors (any `async def` method) default to concurrent
        execution so await-a-later-call patterns work out of the box
        (reference: asyncio actors default max_concurrency=1000;
        capped lower here because each in-flight call holds an exec
        thread while its coroutine runs on the shared loop)."""
        import inspect
        for _, m in inspect.getmembers(
                self._cls, inspect.iscoroutinefunction):
            return 100
        return 1

    def remote(self, *args: Any, **kwargs: Any) -> ActorHandle:
        ctx = worker_mod.client_context()
        if ctx is not None:
            # thin-client session: proxy actor creation (call-time mode
            # resolution; see RemoteFunction.remote); cached so the class
            # ships once
            if self._client_ac is None or self._client_ac._ctx is not ctx:
                self._client_ac = ctx.remote(self._cls, **self._options)
            return self._client_ac.remote(*args, **kwargs)
        w = worker_mod.global_worker()
        cw = w.core_worker
        opts = self._options
        name = opts.get("name") or ""
        namespace = opts.get("namespace") or w.namespace
        method_opts = self._method_options()
        groups = self._concurrency_groups(method_opts)
        group_names = sorted(groups or {})

        if name and opts.get("get_if_exists"):
            info = cw._gcs.call("get_named_actor", name=name,
                                namespace=namespace)
            if info is not None and info.state != "DEAD":
                if self._fn_key is None:
                    self._fn_key = cw.export_function(self._cls)
                return ActorHandle(
                    info.actor_id, self._cls.__name__,
                    self._method_names(), self._fn_key,
                    method_opts, group_names,
                    int(opts.get("max_pending_calls", -1)))

        if self._fn_key is None:
            self._fn_key = cw.export_function(self._cls)
        actor_id = ActorID.of(cw.job_id)
        args_blob, arg_refs = pack_args(args, kwargs)
        strategy = opts.get("scheduling_strategy") or \
            DefaultSchedulingStrategy()
        pg_id, bundle_idx = _extract_pg(opts, strategy)
        lifetime = opts.get("lifetime")
        max_restarts = int(opts.get("max_restarts", 0))
        spec = TaskSpec(
            task_id=TaskID.for_actor_creation(actor_id), job_id=cw.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            function_key=self._fn_key, function_name=self._cls.__name__,
            args=args_blob, arg_object_refs=arg_refs, num_returns=0,
            # reference semantics: actors default to 0 CPU for their
            # lifetime (ray_option_utils: num_cpus default 1 for creation,
            # 0 held) — we hold what's requested, defaulting to 0.
            resources=build_resources(opts, default_num_cpus=0.0),
            owner_address=cw.address, owner_worker_id=cw.worker_id,
            actor_id=actor_id, max_restarts=max_restarts,
            max_task_retries=int(opts.get("max_task_retries", 0)),
            max_concurrency=int(opts.get("max_concurrency",
                                         self._default_concurrency())),
            concurrency_groups=groups,
            scheduling_strategy=strategy, placement_group_id=pg_id,
            placement_group_bundle_index=bundle_idx,
            runtime_env=validate_runtime_env(opts.get("runtime_env")),
            name=name, namespace=namespace,
            detached=(lifetime == "detached"))
        import pickle
        cw._gcs.call("kv_put", key=f"__actor_spec_meta:{actor_id.hex()}",
                     value=pickle.dumps((self._fn_key, self._method_names(),
                                         method_opts, group_names,
                                         int(opts.get("max_pending_calls",
                                                      -1)))))
        try:
            cw.create_actor(spec, name=name, namespace=namespace)
        except Exception as e:  # noqa: BLE001
            # Reclaim the spec metadata written above — but ONLY when
            # the GCS confirms it never registered this actor. A lost
            # RPC response can raise client-side after a server-side
            # success; deleting the meta then would orphan a LIVE actor
            # (get_actor() needs it forever after).
            try:
                reg = cw._gcs.call("get_actor_info",
                                   actor_id_hex=actor_id.hex())
                if reg is None:
                    cw._gcs.call(
                        "kv_del",
                        key=f"__actor_spec_meta:{actor_id.hex()}")
            except Exception:  # noqa: BLE001
                pass  # unreachable GCS: leave the meta in place
            # get_if_exists race: two creators checked the directory,
            # found nothing, and both registered — the loser must fall
            # back to the winner's actor, not error (reference
            # get_if_exists semantics; surfaced by the seeded-chaos
            # interleaving sweep, tests/test_fault_tolerance.py)
            if name and opts.get("get_if_exists"):
                info = cw._gcs.call("get_named_actor", name=name,
                                    namespace=namespace)
                if info is not None and info.state != "DEAD":
                    return ActorHandle(
                        info.actor_id, self._cls.__name__,
                        self._method_names(), self._fn_key,
                        method_opts, group_names,
                        int(opts.get("max_pending_calls", -1)))
            raise
        return ActorHandle(actor_id, self._cls.__name__,
                           self._method_names(), self._fn_key,
                           method_opts, group_names,
                           int(opts.get("max_pending_calls", -1)))


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    """Look up a named actor (reference ray.get_actor)."""
    ctx = worker_mod.client_context()
    if ctx is not None:
        return ctx.get_actor(name, namespace=namespace)
    w = worker_mod.global_worker()
    info = w.core_worker._gcs.call("get_named_actor", name=name,
                                   namespace=namespace or w.namespace)
    if info is None or info.state == "DEAD":
        raise ValueError(f"no live actor named '{name}'")
    fn_key, methods, method_opts, group_names, max_pending = \
        _actor_class_meta(w, info.actor_id.hex())
    return ActorHandle(info.actor_id, info.class_name, methods, fn_key,
                       method_opts, group_names, max_pending)


def _actor_class_meta(w: Any, actor_id_hex: str):
    """Fetch the actor's exported class key + method metadata via GCS."""
    spec: TaskSpec = w.core_worker._gcs.call(
        "kv_get", key=f"__actor_spec_meta:{actor_id_hex}")
    if spec is None:
        raise ValueError(f"actor {actor_id_hex[:12]} metadata missing")
    import pickle
    meta = pickle.loads(spec)
    if len(meta) == 2:  # pre-concurrency-group metadata
        fn_key, methods = meta
        return fn_key, methods, {}, [], -1
    if len(meta) == 4:  # pre-max_pending_calls metadata
        return (*meta, -1)
    return meta
