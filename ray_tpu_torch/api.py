"""Public core API: init/remote/get/put/wait/kill/cancel and cluster info.

reference parity: python/ray/_private/worker.py — ray.get (:2506), ray.put
(:2621), ray.wait (:2684), ray.kill (:2850), ray.cancel (:2881), @ray.remote
(:3157); cluster info helpers from python/ray/_private/state.py.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction


def init(address: Optional[str] = None, **kwargs: Any):
    """Start/connect the runtime (reference worker.py:1165)."""
    return worker_mod.init(address, **kwargs)


def shutdown() -> None:
    worker_mod.shutdown()


def is_initialized() -> bool:
    return worker_mod.is_initialized()


def remote(*args: Any, **options: Any):
    """@remote decorator for functions and classes (reference worker.py:3157)."""
    def make(target: Any):
        # Always build the local wrappers: they defer client-vs-direct
        # routing to CALL time, so modules may decorate at import before
        # init("ray://...") connects.
        if inspect.isclass(target):
            return ActorClass(target, options)
        return RemoteFunction(target, options)

    if len(args) == 1 and not options and callable(args[0]):
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")
    return make


def put(value: Any) -> ObjectRef:
    ctx = worker_mod.client_context()
    if ctx is not None:
        return ctx.put(value)
    return worker_mod.global_worker().core_worker.put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    ctx = worker_mod.client_context()
    if ctx is not None:
        return ctx.get(refs, timeout=timeout)
    cw = worker_mod.global_worker().core_worker
    if isinstance(refs, ObjectRef):
        return cw.get([refs], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"ray_tpu_torch.get takes an ObjectRef or a list of "
                        f"ObjectRefs, got {type(refs).__name__}")
    _check_refs(refs, "get")
    return cw.get(list(refs), timeout=timeout)


def _check_refs(refs: Sequence[Any], api: str) -> None:
    for i, r in enumerate(refs):
        if not isinstance(r, ObjectRef):
            raise TypeError(
                f"ray_tpu_torch.{api} takes ObjectRefs; element {i} is "
                f"{type(r).__name__} ({r!r})")


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None):
    if isinstance(refs, ObjectRef):
        raise TypeError("ray_tpu_torch.wait takes a list of ObjectRefs, got a "
                        "bare ObjectRef (wrap it in a list)")
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"ray_tpu_torch.wait takes a list of ObjectRefs, got "
                        f"{type(refs).__name__}")
    if num_returns <= 0:
        if num_returns == 0 and not refs:
            # wait([], num_returns=len([])) is a common drain pattern
            return [], []
        # returning ([], refs) for num_returns=0 on real refs looks like
        # "nothing ready yet" and silently disables the caller's
        # backpressure
        raise ValueError(
            f"ray_tpu_torch.wait needs num_returns >= 1, got {num_returns}")
    ctx = worker_mod.client_context()
    if ctx is not None:
        # client mode carries ClientObjectRefs; the server side
        # re-validates element types against the real ObjectRef
        return ctx.wait(list(refs), num_returns=num_returns,
                        timeout=timeout)
    _check_refs(refs, "wait")
    cw = worker_mod.global_worker().core_worker
    return cw.wait(list(refs), num_returns=num_returns, timeout=timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    ctx = worker_mod.client_context()
    if ctx is not None:
        ctx.kill(actor, no_restart=no_restart)
        return
    cw = worker_mod.global_worker().core_worker
    cw.kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = True) -> None:
    cw = worker_mod.global_worker().core_worker
    cw.cancel_task(ref)


def free(refs: Sequence[ObjectRef]) -> None:
    worker_mod.global_worker().core_worker.free(list(refs))


# ---- cluster introspection ------------------------------------------------

def nodes() -> List[Dict[str, Any]]:
    w = worker_mod.global_worker()
    infos = w.core_worker._gcs.call("get_all_nodes")
    return [{
        "NodeID": n.node_id.hex(), "Alive": n.alive,
        "NodeManagerAddress": n.address[0], "NodeManagerPort": n.address[1],
        "Resources": dict(n.resources_total), "Labels": dict(n.labels),
        "IsHead": n.is_head,
    } for n in infos]


def cluster_resources() -> Dict[str, float]:
    w = worker_mod.global_worker()
    view = w.core_worker._gcs.call("get_cluster_resources")
    total: Dict[str, float] = {}
    for entry in view.values():
        for k, v in entry["total"].items():
            total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> Dict[str, float]:
    w = worker_mod.global_worker()
    view = w.core_worker._gcs.call("get_cluster_resources")
    avail: Dict[str, float] = {}
    for entry in view.values():
        for k, v in entry["available"].items():
            avail[k] = avail.get(k, 0.0) + v
    return avail


def timeline(filename: Optional[str] = None, *, spans: bool = False,
             trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Dump cluster execution as Chrome-trace JSON (reference `ray
    timeline`, scripts/scripts.py:1856; load via chrome://tracing or
    Perfetto).

    spans=True additionally gathers every process's flight-recorder ring
    (microsecond spans on the RPC/store/serialization/task/feed hot
    paths — see _private/spans.py), aligns per-process clocks, and
    interleaves them with the task events plus CHAOS_FAULT_INJECTED
    cluster events. trace_id filters the dump to one `start_trace`
    block's task records and span records."""
    import json

    from ray_tpu_torch._private.task_events import timeline_events
    from ray_tpu_torch.util import state as state_api
    records = state_api.list_tasks(
        filters={"trace_id": trace_id} if trace_id else None)
    events = timeline_events(records)
    if spans:
        from ray_tpu_torch._private import spans as spans_mod
        w = worker_mod.global_worker()
        snaps = w.core_worker._gcs.call("spans_collect")
        events.extend(spans_mod.merge_snapshots(snaps, trace_id=trace_id))
        # chaos faults as instant events on a synthetic row, so injected
        # failures line up visually with the latency they caused
        if not trace_id:
            for ev in state_api.list_cluster_events(
                    event_type="CHAOS_FAULT_INJECTED"):
                events.append({
                    "ph": "i", "cat": "chaos",
                    "name": "CHAOS_FAULT_INJECTED",
                    "pid": "chaos", "tid": ev.get("fault") or "fault",
                    "ts": float(ev.get("ts", 0.0)) * 1e6, "s": "g",
                    "args": {"rule_id": ev.get("rule_id"),
                             "fault": ev.get("fault"),
                             "message": ev.get("message")},
                })
        events.sort(key=lambda e: e.get("ts", 0.0))
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events


def get_gcs_address() -> str:
    w = worker_mod.global_worker()
    host, port = w.gcs_address
    return f"{host}:{port}"


class _RuntimeContext:
    """reference parity: ray.runtime_context.RuntimeContext."""

    @property
    def worker(self):
        return worker_mod.global_worker()

    def get_job_id(self) -> str:
        return self.worker.core_worker.job_id.hex()

    def get_node_id(self) -> str:
        return self.worker.core_worker.node_id_hex

    def get_worker_id(self) -> str:
        return self.worker.core_worker.worker_id.hex()

    def get_task_id(self) -> str:
        return self.worker.core_worker.current_task_id().hex()

    def get_actor_id(self) -> Optional[str]:
        cw = self.worker.core_worker
        if cw.executor is not None and cw.executor.actor_id is not None:
            return cw.executor.actor_id.hex()
        return None

    def get_task_queue_depth(self, group: str = "") -> int:
        """Queued + running tasks on this worker's executor for one
        concurrency group — the server-side ongoing-request count serve
        replicas report to the router (reference: replica queue-length
        probes behind PowerOfTwoChoicesReplicaScheduler,
        serve/_private/router.py:893)."""
        ex = self.worker.core_worker.executor
        return ex.queue_depth(group) if ex is not None else 0

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False


def get_runtime_context() -> _RuntimeContext:
    return _RuntimeContext()
