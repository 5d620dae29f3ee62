"""Thin-client side of the proxy protocol.

reference parity: python/ray/util/client/worker.py — a ClientContext
installed by ray_tpu_torch.init("ray://host:port"); remote functions/actors
created while connected proxy through it instead of a local core worker.
"""

from __future__ import annotations

import pickle
import queue
import threading
import uuid
from typing import Any, Dict, List, Optional

import cloudpickle

# Proxy-side resolver installed by the server thread unpickling client
# args: refs at ANY pickle depth resolve straight to the proxy's real
# ObjectRefs. On the client side (no resolver) they reconstruct as
# ClientObjectRefs against the process's active context.
_proxy_resolver = threading.local()
_active_context: Optional["ClientContext"] = None


def _resolve_ref(ref_bin: bytes):
    resolver = getattr(_proxy_resolver, "resolver", None)
    if resolver is not None:
        return resolver(ref_bin)
    if _active_context is None:
        raise RuntimeError("no active ray_tpu client context")
    return ClientObjectRef(ref_bin, _active_context)


class ClientObjectRef:
    __slots__ = ("_bin", "_ctx")

    def __init__(self, ref_bin: bytes, ctx: "ClientContext"):
        self._bin = ref_bin
        self._ctx = ctx

    def hex(self) -> str:
        return self._bin.hex()

    def __reduce__(self):
        # at any nesting depth in pickled args, resolve proxy-side
        return (_resolve_ref, (self._bin,))

    def __repr__(self) -> str:
        return f"ClientObjectRef({self.hex()[:16]})"

    def __del__(self):
        # async: a synchronous RPC here could deadlock if GC fires on a
        # thread already inside the (non-reentrant) RpcClient lock
        try:
            self._ctx._release_async(self._bin)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


class ClientRemoteFunction:
    def __init__(self, ctx: "ClientContext", fn: Any,
                 options: Optional[Dict[str, Any]] = None):
        self._ctx = ctx
        self._fn = fn
        self._options = dict(options or {})
        self._key: Optional[str] = None

    def options(self, **kwargs: Any) -> "ClientRemoteFunction":
        rf = ClientRemoteFunction(self._ctx, self._fn,
                                  {**self._options, **kwargs})
        rf._key = self._key
        return rf

    def remote(self, *args: Any, **kwargs: Any):
        ctx = self._ctx
        if self._key is None:
            self._key = ctx._call(
                "cl_register_fn", fn_blob=cloudpickle.dumps(self._fn),
                options={})
        ref_bins = ctx._call(
            "cl_task", fn_key=self._key,
            args_blob=cloudpickle.dumps((args, kwargs)),
            options=self._options)
        refs = [ClientObjectRef(b, ctx) for b in ref_bins]
        num_returns = self._options.get("num_returns", 1)
        if num_returns in ("dynamic", "streaming"):
            num_returns = 1  # the handle is the single return
        return refs if (num_returns != 1 or len(refs) > 1) else refs[0]


class _ClientActorMethod:
    def __init__(self, handle: "ClientActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args: Any, **kwargs: Any):
        ctx = self._handle._ctx
        ref_bins = ctx._call(
            "cl_actor_call", actor_id_bin=self._handle._actor_id_bin,
            method_name=self._name,
            args_blob=cloudpickle.dumps((args, kwargs)))
        if len(ref_bins) == 1:
            return ClientObjectRef(ref_bins[0], ctx)
        # @method(num_returns=N): one client ref per return value
        return [ClientObjectRef(b, ctx) for b in ref_bins]


class ClientActorHandle:
    def __init__(self, ctx: "ClientContext", actor_id_bin: bytes):
        self._ctx = ctx
        self._actor_id_bin = actor_id_bin

    def __getattr__(self, name: str) -> _ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClientActorMethod(self, name)


class ClientActorClass:
    def __init__(self, ctx: "ClientContext", cls: type,
                 options: Optional[Dict[str, Any]] = None):
        self._ctx = ctx
        self._cls = cls
        self._options = dict(options or {})

    def options(self, **kwargs: Any) -> "ClientActorClass":
        return ClientActorClass(self._ctx, self._cls,
                                {**self._options, **kwargs})

    def remote(self, *args: Any, **kwargs: Any) -> ClientActorHandle:
        ctx = self._ctx
        actor_bin = ctx._call(
            "cl_create_actor", cls_blob=cloudpickle.dumps(self._cls),
            args_blob=cloudpickle.dumps((args, kwargs)),
            options=self._options)
        return ClientActorHandle(ctx, actor_bin)


class ClientContext:
    """The per-process client session (reference client worker.py)."""

    def __init__(self, address: str):
        from ray_tpu_torch._private import rpc as rpc_lib
        host, port = address.rsplit(":", 1)
        self.client_id = uuid.uuid4().hex[:12]
        # no socket timeout: a blocking get on a long task keeps this
        # connection legitimately silent for its whole runtime
        self._rpc = rpc_lib.RpcClient((host, int(port)), timeout=None)
        self._lock = threading.Lock()
        self._release_queue: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._release_loop, daemon=True,
                         name="client-release").start()
        assert self._rpc.call("cl_ping") == "pong"
        global _active_context
        _active_context = self

    def _call(self, method: str, **kwargs: Any) -> Any:
        return self._rpc.call(method, client_id=self.client_id, **kwargs)

    def _release_async(self, ref_bin: bytes) -> None:
        self._release_queue.put(ref_bin)

    def _release_loop(self) -> None:
        while True:
            ref_bin = self._release_queue.get()
            if ref_bin is None:
                return
            # batch whatever else is queued
            bins = [ref_bin]
            try:
                while True:
                    nxt = self._release_queue.get_nowait()
                    if nxt is None:
                        return
                    bins.append(nxt)
            except queue.Empty:
                pass
            try:
                self._call("cl_release", ref_bins=bins)
            except Exception:  # noqa: BLE001 - proxy gone
                return

    # -- public surface mirrored by the api shims ---------------------

    def remote(self, target: Any, **options: Any):
        import inspect
        if inspect.isclass(target):
            return ClientActorClass(self, target, options)
        return ClientRemoteFunction(self, target, options)

    def put(self, value: Any) -> ClientObjectRef:
        ref_bins = self._call("cl_put", value_blob=cloudpickle.dumps(value))
        return ClientObjectRef(ref_bins[0], self)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ClientObjectRef)
        if single:
            refs = [refs]
        blob = self._call("cl_get", ref_bins=[r._bin for r in refs],
                          timeout=timeout)
        values = pickle.loads(blob)
        return values[0] if single else values

    def wait(self, refs, num_returns: int = 1,
             timeout: Optional[float] = None):
        by_bin = {r._bin: r for r in refs}
        ready_bins, rest_bins = self._call(
            "cl_wait", ref_bins=[r._bin for r in refs],
            num_returns=num_returns, timeout=timeout)
        return ([by_bin[b] for b in ready_bins],
                [by_bin[b] for b in rest_bins])

    def get_actor(self, name: str, namespace: str = ""
                  ) -> ClientActorHandle:
        actor_bin = self._call(
            "cl_get_named_actor", name=name,
            namespace=namespace or getattr(self, "namespace", ""))
        return ClientActorHandle(self, actor_bin)

    def kill(self, actor: ClientActorHandle,
             no_restart: bool = True) -> None:
        self._call("cl_kill_actor", actor_id_bin=actor._actor_id_bin,
                   no_restart=no_restart)

    def cluster_info(self) -> Dict[str, Any]:
        return self._rpc.call("cl_cluster_info")

    def disconnect(self) -> None:
        self._release_queue.put(None)
        try:
            self._call("cl_disconnect")
        except Exception:  # noqa: BLE001 - server gone; disconnect is best-effort
            pass
        self._rpc.close()
        global _active_context
        if _active_context is self:
            _active_context = None


def connect(address: str) -> ClientContext:
    """address: 'host:port' of a running ClientProxyServer."""
    return ClientContext(address)
