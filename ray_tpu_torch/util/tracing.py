"""Distributed tracing: trace-context propagation + trace queries.

reference parity: python/ray/util/tracing/tracing_helper.py — the trace
context rides inside the task spec (_DictPropagator) so every task an
operation fans out to shares one trace id, with parent task links. No
OpenTelemetry dependency: spans ARE the task-event records (state API /
timeline), queried by trace id.
"""

from __future__ import annotations

import contextlib
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod


def get_current_trace_id() -> Optional[str]:
    """The trace id of the currently-executing task (None in a driver
    outside any start_trace block)."""
    w = worker_mod.global_worker_or_none()
    if w is None:
        return None
    return w.core_worker.current_trace_id()


@contextlib.contextmanager
def use_trace(trace_id: str, name: Optional[str] = None):
    """Adopt an EXTERNALLY-minted trace id for the current thread:
    every task submitted inside the block (and transitively, their
    children) carries it. This is the ingress half of request tracing —
    the Serve HTTP/gRPC proxies wrap each request in use_trace(<the
    X-Request-Id header, or a minted id>) so one id links proxy →
    handle → replica → nested deployment calls in `ray_tpu timeline
    --trace-id` (see README "Serve request telemetry")."""
    w = worker_mod.global_worker()
    cw = w.core_worker
    prev_id = cw.current_trace_id()
    prev_name = cw.current_trace_name()
    cw.set_current_trace(trace_id, name=name)
    try:
        yield trace_id
    finally:
        cw.set_current_trace(prev_id, name=prev_name)


@contextlib.contextmanager
def start_trace(name: str = ""):
    """Group every task submitted in this block (and transitively, their
    children) under one trace id; yields the id. `name` labels the
    block's directly-submitted task records (field `trace_name`)."""
    w = worker_mod.global_worker()
    cw = w.core_worker
    prev_id = cw.current_trace_id()
    prev_name = cw.current_trace_name()
    trace_id = uuid.uuid4().hex[:16]
    cw.set_current_trace(trace_id, name=name or None)
    try:
        yield trace_id
    finally:
        cw.set_current_trace(prev_id, name=prev_name)


def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """All task records of one trace, submission-ordered (reference:
    `ray timeline` filtered to a trace)."""
    from ray_tpu_torch.util import state as state_api
    records = state_api.list_tasks(filters={"trace_id": trace_id})
    return sorted(records, key=lambda r: r.get("ts_submitted", 0.0))


def trace_tree(trace_id: str) -> Dict[str, List[Dict[str, Any]]]:
    """parent task id (or 'root') -> child task records."""
    tree: Dict[str, List[Dict[str, Any]]] = {}
    for rec in get_trace(trace_id):
        parent = rec.get("parent_task_id") or "root"
        tree.setdefault(parent, []).append(rec)
    return tree
