"""Structured cluster-event schema + fire-and-forget emit helper.

reference parity: src/ray/util/event.h (RayEvent record shape) — ONE
place owns the record schema so every emitter (GCS, node manager,
autoscaler, applications via the state API) stays in sync.
"""

from __future__ import annotations

import time
from typing import Any, Dict

SEVERITIES = ("INFO", "WARNING", "ERROR")


def build_event(source: str, event_type: str, message: str = "",
                severity: str = "INFO", **fields: Any) -> Dict[str, Any]:
    return {
        "ts": time.time(),
        "source": source,
        "event_type": event_type,
        "severity": severity if severity in SEVERITIES else "INFO",
        "message": message,
        **fields,
    }


def emit_via(gcs_call, source: str, event_type: str, message: str = "",
             severity: str = "INFO", **fields: Any) -> None:
    """Best-effort emit through a GCS client's .call; never raises."""
    try:
        gcs_call("add_events", events=[build_event(
            source, event_type, message, severity, **fields)])
    except Exception:  # noqa: BLE001 - events must never break the caller
        pass
