"""RemoteFunction: @ray_tpu_torch.remote on a function.

reference parity: python/ray/remote_function.py (RemoteFunction._remote at
:261, submit at :420) and the option surface of
python/ray/_private/ray_option_utils.py:120-238.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.state import (DefaultSchedulingStrategy, TaskSpec,
                                    TaskType)

_TASK_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "resources", "num_returns",
    "max_retries", "retry_exceptions", "scheduling_strategy", "runtime_env",
    "name", "memory", "accelerator_type", "max_calls", "_metadata",
    "placement_group", "placement_group_bundle_index",
    "placement_group_capture_child_tasks", "object_store_memory",
}


_RUNTIME_ENV_KEYS = {"env_vars", "working_dir", "py_modules", "pip",
                     "conda", "container"}


def validate_runtime_env(renv):
    """Reject runtime_env fields this runtime doesn't implement —
    accepting and silently ignoring them would be worse than failing
    fast — and validate the implemented ones' specs at submission time
    (reference _private/runtime_env/{pip,conda,container}.py)."""
    if renv is None:
        return None
    bad = set(renv) - _RUNTIME_ENV_KEYS
    if bad:
        raise ValueError(
            f"unsupported runtime_env field(s) {sorted(bad)}; this "
            f"runtime implements {sorted(_RUNTIME_ENV_KEYS)}")
    from ray_tpu_torch._private.runtime_env import (conda_spec, container_spec,
                                              pip_spec)
    pip_spec(renv)        # each raises on malformed specs at
    conda_spec(renv)      # submission time, not at worker spawn
    container_spec(renv)
    return renv


def build_resources(options: Dict[str, Any],
                    default_num_cpus: float = 1.0) -> Dict[str, float]:
    resources = dict(options.get("resources") or {})
    num_cpus = options.get("num_cpus")
    resources["CPU"] = float(default_num_cpus if num_cpus is None else num_cpus)
    if options.get("num_gpus"):
        resources["GPU"] = float(options["num_gpus"])
    if options.get("num_tpus"):
        resources["TPU"] = float(options["num_tpus"])
    if options.get("memory"):
        resources["memory"] = float(options["memory"])
    return {k: v for k, v in resources.items() if v}


def pack_args(args: tuple, kwargs: dict) -> "tuple[bytes, List[ObjectID]]":
    """Serialize args, collecting every ObjectRef at ANY nesting depth so
    the submitter pins them all until the task completes (a ref inside a
    list freed mid-flight would otherwise vanish under the executing
    worker)."""
    from ray_tpu_torch._private.object_ref import collect_serialized_refs
    collected: List[ObjectRef] = []
    with collect_serialized_refs(collected):
        blob = ser.pack((args, kwargs))
    seen = set()
    refs = []
    for r in collected:
        if r.id.hex() not in seen:
            seen.add(r.id.hex())
            refs.append(r.id)
    return blob, refs


class RemoteFunction:
    def __init__(self, fn: Any, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        bad = set(self._options) - _TASK_OPTIONS
        if bad:
            raise ValueError(f"invalid task options: {sorted(bad)}")
        self._fn_key: Optional[str] = None
        self._client_rf = None  # cached thin-client wrapper (ray:// mode)
        functools.update_wrapper(self, fn)

    def options(self, **kwargs: Any) -> "RemoteFunction":
        merged = {**self._options, **kwargs}
        rf = RemoteFunction(self._fn, merged)
        rf._fn_key = self._fn_key
        return rf

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise TypeError(
            f"remote function '{self._fn.__name__}' cannot be called "
            f"directly; use .remote()")

    def bind(self, *args: Any, **kwargs: Any):
        """Lazy graph node (reference dag/function_node.py): builds a
        ray_tpu_torch.dag.FunctionNode instead of submitting now."""
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    def remote(self, *args: Any, **kwargs: Any) -> Any:
        ctx = worker_mod.client_context()
        if ctx is not None:
            # thin-client session: proxy the call (mode resolved at call
            # time so decoration may precede init("ray://...")); cache
            # the wrapper so the function ships/registers once, not per
            # submission
            if self._client_rf is None or self._client_rf._ctx is not ctx:
                self._client_rf = ctx.remote(self._fn, **self._options)
            return self._client_rf.remote(*args, **kwargs)
        w = worker_mod.global_worker()
        cw = w.core_worker
        if self._fn_key is None:
            self._fn_key = cw.export_function(self._fn)
        opts = self._options
        args_blob, arg_refs = pack_args(args, kwargs)
        strategy = opts.get("scheduling_strategy") or \
            DefaultSchedulingStrategy()
        pg_id, bundle_idx = _extract_pg(opts, strategy)
        num_returns = opts.get("num_returns", 1)
        dynamic = num_returns in ("dynamic", "streaming")
        if dynamic:
            num_returns = 1  # the generator handle itself
        spec = TaskSpec(
            task_id=TaskID.of(cw.job_id), job_id=cw.job_id,
            task_type=TaskType.NORMAL_TASK, function_key=self._fn_key,
            function_name=self._fn.__name__, args=args_blob,
            arg_object_refs=arg_refs, num_returns=num_returns,
            resources=build_resources(opts),
            owner_address=cw.address, owner_worker_id=cw.worker_id,
            max_retries=opts.get("max_retries",
                                 Config.default_task_max_retries),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            max_calls=int(opts.get("max_calls", 0)),
            scheduling_strategy=strategy,
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle_idx,
            runtime_env=validate_runtime_env(opts.get("runtime_env")),
            name=opts.get("name") or self._fn.__name__)
        spec.dynamic_returns = dynamic
        refs = cw.submit_task(spec)
        if dynamic and opts.get("num_returns") == "streaming":
            # iterate children as the task yields them (reference
            # StreamingObjectRefGenerator); "dynamic" keeps the batch
            # list-of-refs handle semantics
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator
            return ObjectRefGenerator(refs[0])
        if num_returns == 1:
            return refs[0]
        return refs


def _extract_pg(opts: Dict[str, Any], strategy: Any):
    from ray_tpu_torch._private.state import PlacementGroupSchedulingStrategy
    pg = opts.get("placement_group")
    bundle_idx = opts.get("placement_group_bundle_index", -1)
    if isinstance(strategy, PlacementGroupSchedulingStrategy) \
            and strategy.placement_group is not None:
        pg = strategy.placement_group
        bundle_idx = strategy.placement_group_bundle_index
    if pg is None:
        return None, -1
    return pg.id, bundle_idx
