"""Node memory monitor + worker-killing policy (OOM defense).

reference parity: src/ray/common/memory_monitor.h:52 (cgroup//proc usage
polling against memory_usage_threshold, ray_config_def.h:77 default
0.95) feeding the raylet's worker-killing policies
(worker_killing_policy_retriable_fifo.h: kill the newest retriable task
first — it loses the least work and its owner retries it elsewhere).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Optional

logger = logging.getLogger(__name__)


def system_memory_usage_fraction() -> float:
    """1 - MemAvailable/MemTotal from /proc/meminfo; test override via
    RAY_TPU_testing_fake_memory_usage."""
    fake = os.environ.get("RAY_TPU_testing_fake_memory_usage")
    if fake:
        return float(fake)
    try:
        fields = {}
        with open("/proc/meminfo") as f:
            for line in f:
                name, _, rest = line.partition(":")
                fields[name] = int(rest.strip().split()[0])
        total = fields.get("MemTotal", 0)
        avail = fields.get("MemAvailable", 0)
        if total <= 0:
            return 0.0
        return 1.0 - avail / total
    except OSError:
        return 0.0


class MemoryMonitor:
    """Polls memory usage; above threshold, invokes the kill callback
    once per breach-poll until usage recovers."""

    def __init__(self, kill_callback: Callable[[], bool],
                 threshold: float, period_s: float,
                 usage_fn: Optional[Callable[[], float]] = None):
        self._kill = kill_callback
        self.threshold = threshold
        self.period_s = period_s
        self._usage = usage_fn or system_memory_usage_fraction
        self.num_kills = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="memory-monitor")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                usage = self._usage()
            except Exception:  # noqa: BLE001 - probe raced an exit; retry next tick
                continue
            if usage < self.threshold:
                continue
            logger.warning(
                "memory usage %.1f%% over threshold %.1f%%: engaging "
                "worker-killing policy", usage * 100,
                self.threshold * 100)
            try:
                if self._kill():
                    self.num_kills += 1
            except Exception:  # noqa: BLE001
                logger.exception("memory-pressure kill failed")

    def stop(self) -> None:
        self._stop.set()
