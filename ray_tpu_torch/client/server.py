"""Client proxy server: hosts driver state for thin clients.

reference parity: python/ray/util/client/server/ (proxier + per-client
server translating the client protocol into core-API calls). The proxy
process is itself a cluster driver; every connected client's refs live
here, tracked per client id so a disconnect releases them.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class ClientProxyServer:
    def __init__(self, gcs_address: str, host: str = "127.0.0.1",
                 port: int = 0):
        import ray_tpu_torch
        from ray_tpu_torch._private import rpc as rpc_lib

        ray_tpu_torch.init(gcs_address, ignore_reinit_error=True)
        self._rt = ray_tpu_torch
        self._lock = threading.Lock()
        # client id -> {ref hex -> ObjectRef} (holds the proxy-side pin)
        self._client_refs: Dict[str, Dict[str, Any]] = {}
        # client id -> {fn key -> RemoteFunction}
        self._client_fns: Dict[str, Dict[str, Any]] = {}
        # client id -> {actor id hex -> (ActorHandle, created_by_client)}
        # created_by_client distinguishes actors the client made (killed
        # on disconnect) from named actors it merely looked up
        self._client_actors: Dict[str, Dict[str, Any]] = {}

        self.server = rpc_lib.RpcServer({
            "cl_register_fn": self.register_fn,
            "cl_task": self.submit_task,
            "cl_put": self.put,
            "cl_get": self.get,
            "cl_wait": self.wait,
            "cl_create_actor": self.create_actor,
            "cl_actor_call": self.actor_call,
            "cl_kill_actor": self.kill_actor,
            "cl_get_named_actor": self.get_named_actor,
            "cl_release": self.release,
            "cl_disconnect": self.disconnect,
            "cl_cluster_info": self.cluster_info,
            "cl_ping": lambda: "pong",
        }, host=host, port=port)
        self.address = self.server.address

    # -- helpers -----------------------------------------------------

    def _track(self, client_id: str, refs: List[Any]) -> List[bytes]:
        out = []
        with self._lock:
            table = self._client_refs.setdefault(client_id, {})
            for r in refs:
                table[r.hex()] = r
                out.append(r.id.binary())
        return out

    def _lookup(self, client_id: str, ref_bins: List[bytes]) -> List[Any]:
        with self._lock:
            table = self._client_refs.get(client_id, {})
            return [table[b.hex()] for b in ref_bins]

    # -- handlers ----------------------------------------------------

    def register_fn(self, client_id: str, fn_blob: bytes,
                    options: Dict[str, Any]) -> str:
        import cloudpickle
        fn = cloudpickle.loads(fn_blob)
        rf = self._rt.remote(fn)
        if options:
            rf = rf.options(**options)
        key = f"{client_id}:{getattr(fn, '__name__', 'fn')}:{id(rf)}"
        with self._lock:
            self._client_fns.setdefault(client_id, {})[key] = rf
        return key

    def _materialize_args(self, client_id: str, args_blob: bytes):
        """Client refs at ANY pickle depth resolve to the proxy's real
        ObjectRefs: ClientObjectRef.__reduce__ routes through
        _resolve_ref, which consults the resolver installed here for the
        duration of the unpickle."""
        import pickle

        from ray_tpu_torch.client.worker import _proxy_resolver
        _proxy_resolver.resolver = \
            lambda b: self._lookup(client_id, [b])[0]
        try:
            args, kwargs = pickle.loads(args_blob)
        finally:
            _proxy_resolver.resolver = None
        return args, kwargs

    def submit_task(self, client_id: str, fn_key: str, args_blob: bytes,
                    options: Dict[str, Any]) -> List[bytes]:
        with self._lock:
            rf = self._client_fns[client_id][fn_key]
        if options:
            rf = rf.options(**options)
        args, kwargs = self._materialize_args(client_id, args_blob)
        refs = rf.remote(*args, **kwargs)
        if not isinstance(refs, list):
            refs = [refs]
        return self._track(client_id, refs)

    def put(self, client_id: str, value_blob: bytes) -> List[bytes]:
        import pickle
        ref = self._rt.put(pickle.loads(value_blob))
        return self._track(client_id, [ref])

    def get(self, client_id: str, ref_bins: List[bytes],
            timeout: Optional[float]) -> bytes:
        refs = self._lookup(client_id, ref_bins)
        values = self._rt.get(refs, timeout=timeout)
        return self._dumps_translating_refs(client_id, values)

    def _dumps_translating_refs(self, client_id: str, value: Any) -> bytes:
        """Pickle result values so any contained ObjectRef (e.g. a
        num_returns="dynamic" handle's list of refs, or refs returned by
        tasks) crosses to the client as a ClientObjectRef, tracked
        proxy-side like every other client ref."""
        import io

        from cloudpickle import CloudPickler

        from ray_tpu_torch._private.object_ref import ObjectRef
        from ray_tpu_torch.client.worker import _resolve_ref
        server = self

        # CloudPickler (not plain Pickler): values may be instances of
        # classes the client shipped by value from its __main__
        class _Pickler(CloudPickler):
            def reducer_override(inner, obj):  # noqa: N805
                if isinstance(obj, ObjectRef):
                    server._track(client_id, [obj])
                    return (_resolve_ref, (obj.id.binary(),))
                return super().reducer_override(obj)

        buf = io.BytesIO()
        _Pickler(buf, protocol=5).dump(value)
        return buf.getvalue()

    def wait(self, client_id: str, ref_bins: List[bytes],
             num_returns: int, timeout: Optional[float]):
        refs = self._lookup(client_id, ref_bins)
        ready, rest = self._rt.wait(refs, num_returns=num_returns,
                                    timeout=timeout)
        return ([r.id.binary() for r in ready],
                [r.id.binary() for r in rest])

    def create_actor(self, client_id: str, cls_blob: bytes, args_blob: bytes,
                     options: Dict[str, Any]) -> bytes:
        import cloudpickle
        cls = cloudpickle.loads(cls_blob)
        ac = self._rt.remote(cls)
        if options:
            ac = ac.options(**options)
        args, kwargs = self._materialize_args(client_id, args_blob)
        handle = ac.remote(*args, **kwargs)
        # get_if_exists may have returned a PRE-EXISTING shared actor:
        # treat those as not-ours so disconnect can't kill an actor other
        # clients rely on (conservative: a genuinely fresh get_if_exists
        # actor then outlives the client, which matches its
        # shared-by-name intent)
        created = not options.get("get_if_exists", False)
        with self._lock:
            table = self._client_actors.setdefault(client_id, {})
            prev = table.get(handle._actor_id.hex())
            table[handle._actor_id.hex()] = (
                handle, created if prev is None else prev[1])
        return handle._actor_id.binary()

    def actor_call(self, client_id: str, actor_id_bin: bytes,
                   method_name: str, args_blob: bytes) -> List[bytes]:
        with self._lock:
            handle, _ = self._client_actors[client_id][actor_id_bin.hex()]
        args, kwargs = self._materialize_args(client_id, args_blob)
        out = getattr(handle, method_name).remote(*args, **kwargs)
        # @method(num_returns=N) tags make .remote() return a LIST of
        # refs; flatten so tracking and the client see each ref
        refs = out if isinstance(out, list) else [out]
        return self._track(client_id, refs)

    def get_named_actor(self, client_id: str, name: str,
                        namespace: str = "") -> bytes:
        handle = self._rt.get_actor(name, namespace=namespace)
        with self._lock:
            table = self._client_actors.setdefault(client_id, {})
            prev = table.get(handle._actor_id.hex())
            # looking up an actor this client CREATED must not demote it
            # to not-ours (it would leak past disconnect)
            table[handle._actor_id.hex()] = (
                handle, False if prev is None else prev[1])
        return handle._actor_id.binary()

    def kill_actor(self, client_id: str, actor_id_bin: bytes,
                   no_restart: bool = True) -> None:
        with self._lock:
            entry = self._client_actors.get(client_id, {}).pop(
                actor_id_bin.hex(), None)
        if entry is not None:
            self._rt.kill(entry[0], no_restart=no_restart)

    def release(self, client_id: str, ref_bins: List[bytes]) -> None:
        with self._lock:
            table = self._client_refs.get(client_id, {})
            for b in ref_bins:
                table.pop(b.hex(), None)

    def disconnect(self, client_id: str) -> None:
        with self._lock:
            self._client_refs.pop(client_id, None)
            self._client_fns.pop(client_id, None)
            actors = self._client_actors.pop(client_id, {})
        for handle, created in actors.values():
            if not created:
                continue  # merely looked-up named actors aren't ours
            try:
                self._rt.kill(handle)
            except Exception:  # noqa: BLE001 - client's actor already dead
                pass

    def cluster_info(self) -> Dict[str, Any]:
        return {"nodes": len(self._rt.nodes()),
                "resources": self._rt.cluster_resources()}

    def stop(self) -> None:
        self.server.stop()


def serve_forever(gcs_address: str, host: str = "127.0.0.1",
                  port: int = 10001) -> None:
    import time
    proxy = ClientProxyServer(gcs_address, host=host, port=port)
    # operator handshake on stdout: scripts scrape the ray:// address
    print(f"client proxy listening on "  # graftlint: disable=RT012
          f"ray://{proxy.address[0]}:{proxy.address[1]}", flush=True)
    try:
        while True:
            time.sleep(1)
    finally:
        proxy.stop()
