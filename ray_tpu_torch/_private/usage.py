"""Usage stats: local-only feature-usage reporting, opt-out.

reference parity: _private/usage/usage_lib.py — the reference pings a
telemetry endpoint unless RAY_USAGE_STATS_ENABLED=0; this build NEVER
egresses (zero-network policy): it records the same feature-usage
report as a JSON file in the session dir so operators can inspect what
their jobs exercised. Same env-var contract: RAY_TPU_USAGE_STATS_ENABLED
(default on; "0"/"false" disables).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Set

_lock = threading.Lock()
_features: Set[str] = set()
_extra: Dict[str, Any] = {}


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS_ENABLED",
                          "1").lower() not in ("0", "false", "no")


def record_library_usage(name: str) -> None:
    """Called by library entry points (train/tune/rllib/data/serve)."""
    if not usage_stats_enabled():
        return
    with _lock:
        _features.add(name)


def record_extra_usage_tag(key: str, value: Any) -> None:
    if not usage_stats_enabled():
        return
    with _lock:
        _extra[key] = value


def usage_report() -> Dict[str, Any]:
    import platform
    with _lock:
        return {
            "schema_version": "0.1",
            "collected_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "python_version": platform.python_version(),
            "os": platform.system().lower(),
            "libraries_used": sorted(_features),
            "extra_tags": dict(_extra),
        }


def write_usage_report(target_dir: str,
                       filename: str = "usage_stats.json") -> str:
    """Persist the report as a local file (no egress). No-op when the
    opt-out env var disables usage stats."""
    path = os.path.join(target_dir, filename)
    if not usage_stats_enabled():
        return path
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(usage_report(), f, indent=2)
    except OSError:
        pass
    return path
