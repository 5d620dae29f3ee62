"""Shared runtime data structures: task specs, resources, node info.

TaskSpecification equivalent of reference src/ray/common/task/task_spec.h —
but as plain dataclasses shipped over the framed-pickle RPC instead of
protobuf. Resource accounting mirrors reference
src/ray/common/scheduling/resource_set.h (fixed-point there; floats with an
epsilon here, quantized to 1e-4 like the reference's FixedPoint).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID, ObjectID,
                                  PlacementGroupID, TaskID, WorkerID)

RESOURCE_EPS = 1e-4


def quantize(v: float) -> float:
    """Quantize to 1e-4 granularity (reference FixedPoint precision)."""
    return round(v / RESOURCE_EPS) * RESOURCE_EPS


class ResourceSet:
    """A bag of named resource quantities with fixed-point-ish arithmetic."""

    __slots__ = ("_r",)

    def __init__(self, resources: Optional[Dict[str, float]] = None):
        self._r = {k: quantize(float(v)) for k, v in (resources or {}).items()
                   if v and float(v) > 0}

    def get(self, name: str) -> float:
        return self._r.get(name, 0.0)

    def to_dict(self) -> Dict[str, float]:
        return dict(self._r)

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other.get(k) + RESOURCE_EPS / 2 >= v for k, v in self._r.items())

    def subtract(self, other: "ResourceSet") -> None:
        for k, v in other._r.items():
            self._r[k] = quantize(self._r.get(k, 0.0) - v)

    def add(self, other: "ResourceSet") -> None:
        for k, v in other._r.items():
            self._r[k] = quantize(self._r.get(k, 0.0) + v)

    def is_empty(self) -> bool:
        return not any(v > RESOURCE_EPS / 2 for v in self._r.values())

    def __repr__(self) -> str:
        return f"ResourceSet({self._r})"


class SchedulingStrategy:
    """Base for scheduling strategies (reference util/scheduling_strategies.py)."""


@dataclass
class DefaultSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass
class SpreadSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass
class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    node_id: str = ""
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    placement_group: Any = None  # PlacementGroup handle
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeLabelSchedulingStrategy(SchedulingStrategy):
    """Label-constrained placement (reference
    util/scheduling_strategies.py:135 + node_label_scheduling_policy.h).
    hard: {label_key: [allowed values]} — every key must match ("" in the
    list means 'key exists'); soft: preferred but not required."""

    hard: Dict[str, List[str]] = field(default_factory=dict)
    soft: Dict[str, List[str]] = field(default_factory=dict)


class TaskType(Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


@dataclass
class TaskSpec:
    """Everything an executor needs to run a task.

    reference parity: src/ray/common/task/task_spec.h TaskSpecification.
    `function_key` points at the exported function/class blob in the GCS
    function table (reference: _private/function_manager.py export keys).
    """

    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function_key: str                  # GCS KV key of the pickled function/class
    function_name: str                 # human-readable, for errors/state API
    args: bytes                        # serialized (args, kwargs) envelope
    arg_object_refs: List[ObjectID]    # top-level ObjectRef deps to resolve
    num_returns: int
    resources: Dict[str, float]
    owner_address: Tuple[str, int]     # core-worker RPC addr of the submitter
    owner_worker_id: WorkerID
    # Actor fields
    actor_id: Optional[ActorID] = None
    actor_method_name: str = ""
    sequence_number: int = -1          # ordering for actor tasks
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    # named concurrency groups (reference concurrency_group_manager.h):
    # creation carries {group: max_concurrency}; each actor call carries
    # the group it executes in ("" = default pool)
    concurrency_groups: Optional[Dict[str, int]] = None
    concurrency_group: str = ""
    # Normal-task fields
    max_retries: int = 0
    retry_exceptions: bool = False
    # worker recycling (reference max_calls option): the worker process
    # exits after executing this function max_calls times — the escape
    # hatch for native libraries that leak
    max_calls: int = 0
    # num_returns="dynamic" (reference _raylet.pyx:269
    # StreamingObjectRefGenerator): the task yields a variable number of
    # values; each becomes its own object, and the single declared
    # return resolves to the list of their refs.
    dynamic_returns: bool = False
    # Scheduling
    scheduling_strategy: SchedulingStrategy = field(
        default_factory=DefaultSchedulingStrategy)
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    # Runtime env (dict: env_vars, working_dir, ...)
    runtime_env: Optional[Dict[str, Any]] = None
    # Data-locality hints: node id hex -> bytes of this task's args
    # already resident there (reference lease_policy.h:56 locality-aware
    # lease policy / scorer.h:25)
    locality_hints: Dict[str, float] = field(default_factory=dict)
    # arg oid hex -> (store address, size): lets the dispatching node
    # manager PREFETCH remote args into its local store while the lease
    # is granted (reference raylet DependencyManager + PullManager pull
    # task args to the node before dispatch)
    arg_locations: Dict[str, Any] = field(default_factory=dict)
    # Tracing (reference util/tracing/tracing_helper.py: context rides
    # inside the task spec): all tasks of one logical request share a
    # trace id; parent_task_id links the causal chain.
    trace_id: Optional[str] = None
    parent_task_id: Optional[str] = None
    # Owner's node id hex: lets an executor on the same node pick the
    # shm ring for its cw_task_done report instead of the loopback
    # socket (_private/shm_channel.py). A real field, not an ad-hoc
    # attribute, so the compact positional pickle fast path holds.
    owner_node_id: str = ""
    # Misc
    name: str = ""
    namespace: str = ""

    detached: bool = False
    submitted_at: float = field(default_factory=time.time)

    def required_resources(self) -> ResourceSet:
        return ResourceSet(self.resources)

    def scheduling_key(self) -> Tuple:
        """Tasks with the same key can reuse a leased worker (reference:
        direct_task_transport lease reuse, SchedulingKey). repr() of the
        strategy (not just its type): NodeAffinity(node A) must not
        reuse a lease held for NodeAffinity(node B)."""
        return (self.function_key, tuple(sorted(self.resources.items())),
                repr(self.scheduling_strategy),
                self.placement_group_id.hex() if self.placement_group_id else "",
                self.placement_group_bundle_index,
                # FULL runtime env, canonicalized (dict insertion order
                # must not split keys): working_dir / py_modules / pip
                # change what a worker has materialized, and a reused
                # lease pins the worker
                _canonical(self.runtime_env) if self.runtime_env else "")

    # Compact pickling: specs cross a process boundary on every task
    # push; the default dataclass reduce ships all 30 field-name strings
    # per spec. A positional tuple roughly halves encode+decode cost on
    # the control-plane hot path (reference keeps specs in protobuf for
    # the same reason). Ad-hoc attributes (e.g. the worker-side
    # _lease_id) ride in the extras dict.
    def __getstate__(self):
        d = self.__dict__
        if len(d) == len(_SPEC_FIELDS):  # common case: no ad-hoc attrs
            extras = None
        else:
            extras = {k: v for k, v in d.items()
                      if k not in _SPEC_FIELD_SET} or None
        return ([d[f] for f in _SPEC_FIELDS], extras)

    def __setstate__(self, state):
        vals, extras = state
        self.__dict__.update(zip(_SPEC_FIELDS, vals))
        if extras:
            self.__dict__.update(extras)


_SPEC_FIELDS = tuple(f.name for f in fields(TaskSpec))
_SPEC_FIELD_SET = frozenset(_SPEC_FIELDS)


def _canonical(v: Any):
    """Order-insensitive hashable form of nested dict/list config."""
    if isinstance(v, dict):
        return tuple(sorted((k, _canonical(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_canonical(x) for x in v)
    return v


class WorkerExitType(Enum):
    IDLE = 0
    INTENDED = 1
    CRASH = 2
    NODE_DEATH = 3


@dataclass
class NodeInfo:
    node_id: NodeID
    address: Tuple[str, int]            # node manager RPC address
    store_address: Tuple[str, int]      # object store server RPC address
    resources_total: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    is_head: bool = False
    start_time: float = field(default_factory=time.time)


@dataclass
class PlacementGroupInfo:
    """GCS placement-group table entry (reference:
    gcs_placement_group_manager.h GcsPlacementGroup; states per
    gcs.proto PlacementGroupTableData)."""
    pg_id: PlacementGroupID
    name: str
    bundles: List[Dict[str, float]]
    strategy: str                        # PACK/SPREAD/STRICT_PACK/STRICT_SPREAD
    state: str = "PENDING"               # PENDING/CREATED/REMOVED/RESCHEDULING
    # node id hex per bundle once committed
    bundle_nodes: List[str] = field(default_factory=list)
    creator_job_id: str = ""
    detached: bool = False


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: str
    namespace: str
    class_name: str
    state: str                           # PENDING/ALIVE/RESTARTING/DEAD
    address: Optional[Tuple[str, int]]   # worker core RPC address when ALIVE
    node_id: Optional[NodeID]
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: str = ""
