"""Task event buffering: per-process event records flushed to the GCS.

reference parity: src/ray/core_worker/task_event_buffer.h:143,206 — every
core worker buffers task state transitions + profile timestamps and flushes
them periodically to the GCS task sink (gcs/gcs_server/gcs_task_manager.h:85),
which the state API (`ray list tasks`) and `ray timeline` read back.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional
from ray_tpu_torch.util.locks import TracedLock

FLUSH_PERIOD_S = 1.0

# Bound on unflushed records: a slow or partitioned GCS (easy to hit
# under chaos partition rules) must not grow _pending without limit in
# every process — oldest deltas are dropped and counted instead.
PENDING_MAX = 8192


class TaskEventBuffer:
    """Accumulates partial task records; a background thread flushes deltas.

    Records are merge-dicts keyed by task id hex: the owner contributes
    SUBMITTED/FINISHED/FAILED transitions, the executing worker contributes
    RUNNING + execution timestamps; the GCS merges both halves.
    """

    def __init__(self, gcs_client: Any, pending_max: int = PENDING_MAX):
        self._gcs = gcs_client
        self._lock = TracedLock("task_events")
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._pending_max = max(1, pending_max)
        self.dropped_total = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._flush_loop, daemon=True,
                                        name="task-events")
        self._thread.start()

    def record(self, task_id_hex: str, **fields: Any) -> None:
        dropped = 0
        with self._lock:
            rec = self._pending.setdefault(task_id_hex,
                                           {"task_id": task_id_hex})
            rec.update({k: v for k, v in fields.items() if v is not None})
            # drop-oldest (dict preserves insertion order): losing an old
            # task's delta beats unbounded memory while the GCS is away
            while len(self._pending) > self._pending_max:
                self._pending.pop(next(iter(self._pending)))
                dropped += 1
            self.dropped_total += dropped
        if dropped:
            try:
                from ray_tpu_torch.util.metrics import Counter, get_or_create
                get_or_create(
                    Counter, "ray_tpu_task_events_dropped_total",
                    description="task-event deltas dropped because the "
                                "pending buffer hit its cap (GCS slow or "
                                "partitioned)").inc(dropped)
            except Exception:  # noqa: BLE001 - metrics are best-effort
                pass

    def _flush_loop(self) -> None:
        while not self._stop.wait(FLUSH_PERIOD_S):
            self.flush()

    def flush(self) -> None:
        with self._lock:
            if not self._pending:
                return
            batch = list(self._pending.values())
            self._pending = {}
        try:
            self._gcs.call("add_task_events", events=batch)
        except Exception:  # noqa: BLE001 - GCS down; drop rather than block
            pass

    def stop(self) -> None:
        self._stop.set()
        self.flush()


def now() -> float:
    return time.time()


def timeline_events(task_records: list,
                    node_names: Optional[Dict[str, str]] = None) -> list:
    """Convert GCS task records into Chrome-trace 'X' (complete) events
    (reference: `ray timeline`, scripts.py:1856 → chrome://tracing JSON)."""
    out = []
    for rec in task_records:
        start = rec.get("ts_running")
        end = rec.get("ts_exec_end")
        if start is None:
            continue
        if end is None:
            end = rec.get("ts_finished") or start
        pid = rec.get("node_id", "driver")[:12]
        if node_names and pid in node_names:
            pid = node_names[pid]
        out.append({
            "ph": "X", "cat": "task",
            "name": rec.get("name", rec.get("task_id", "?")[:12]),
            "pid": pid,
            "tid": rec.get("worker_id", "?")[:12],
            "ts": start * 1e6,
            "dur": max(end - start, 0.0) * 1e6,
            "args": {
                "task_id": rec.get("task_id"),
                "state": rec.get("state"),
                "type": rec.get("type"),
            },
        })
    return out
