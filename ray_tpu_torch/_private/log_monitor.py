"""LogMonitor: tail worker log files, index + publish attributed lines.

reference parity: python/ray/_private/log_monitor.py:103 — a per-node
process tails the session log dir and publishes new lines through GCS
pubsub; drivers print them with a (worker, node) prefix
(worker.py:1823 print_to_stdstream). Here it's a daemon thread inside
each node manager that additionally:

  - parses each line's attribution stamp (log_plane.parse_line: proc
    kind/pid, task id, actor id, trace id, level),
  - keeps a bounded per-worker in-memory tail index with rotation-safe
    offsets (inode change or truncation resets the offset) that the
    node manager serves to the GCS `logs_query` fan-out, and
  - flood-controls the driver stream: a per-source token bucket caps
    published lines/sec; dropped lines are counted (they stay in the
    tail index — only the live stream sheds).
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import log_plane
from ray_tpu_torch._private.config import Config
from ray_tpu_torch.util.locks import TracedLock

logger = logging.getLogger(__name__)


class LogMonitor:
    def __init__(self, log_dir: str, gcs_address: Optional[Tuple[str, int]],
                 node_id_hex: str, poll_interval: float = 0.25,
                 tail_lines: Optional[int] = None,
                 rate_lps: Optional[float] = None,
                 burst: Optional[int] = None,
                 _client: Any = None):
        self.log_dir = log_dir
        self.node_id_hex = node_id_hex
        self.poll_interval = poll_interval
        self.tail_lines = tail_lines or Config.log_tail_lines
        self.rate_lps = Config.log_stream_rate_lps \
            if rate_lps is None else rate_lps
        self.burst = burst or Config.log_stream_burst
        # file name -> (inode, offset): rotation/truncation safe — an
        # inode change (logrotate-style replace) or a size below the
        # recorded offset (copytruncate) restarts the tail at 0
        self._offsets: Dict[str, Tuple[int, int]] = {}
        self._tails: Dict[str, "collections.deque"] = {}
        self._seq = itertools.count()
        # flood control state per source: (tokens, last_refill_mono);
        # touched only by the single publisher (monitor thread, or
        # stop()'s final drain after the join)
        self._bucket: Dict[str, Tuple[float, float]] = {}
        self.dropped_by_source: Dict[str, int] = {}
        self._scan_lock = TracedLock("log_monitor_scan")
        # (source, records) awaiting publication, guarded by _scan_lock.
        # Scans queue here and the monitor thread publishes OUTSIDE the
        # lock: the publish RPC can block up to its 30s client timeout
        # (slow/partitioned GCS), and holding the lock through it would
        # stall logs_snapshot queries and postmortem capture.
        self._publish_q: List[Tuple[str, List[Dict[str, Any]]]] = []
        self._stop = threading.Event()
        if _client is not None:
            self._gcs = _client
        else:
            from ray_tpu_torch._private.rpc import RpcClient
            self._gcs = RpcClient(tuple(gcs_address), timeout=30)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="log-monitor")
        self._thread.start()

    # ---- tail index + queries -------------------------------------------

    def _source_records(self, source: str, lines: List[str]
                        ) -> List[Dict[str, Any]]:
        worker_id = source[len("worker-"):] if source.startswith("worker-") \
            else source
        out = []
        for raw in lines:
            rec = log_plane.parse_line(raw)
            rec["node_id"] = self.node_id_hex[:12]
            rec["worker_id"] = worker_id
            rec["source"] = source
            rec["seq"] = next(self._seq)
            if rec["ts"] is None:
                rec["ts"] = time.time()
            out.append(rec)
        return out

    def query(self, filters: Optional[Dict[str, Any]] = None,
              tail: int = 500) -> List[Dict[str, Any]]:
        """Filtered view over the node's tail index, oldest-first,
        trimmed to the last `tail` records."""
        with self._scan_lock:
            records: List[Dict[str, Any]] = []
            for dq in self._tails.values():
                records.extend(dq)
        records = log_plane.filter_records(records, filters)
        records.sort(key=lambda r: (r.get("ts") or 0.0, r.get("seq", 0)))
        return records[-int(tail):] if tail else records

    def tail_records(self, source: str, n: int) -> List[Dict[str, Any]]:
        with self._scan_lock:
            dq = self._tails.get(source)
            recs = list(dq) if dq is not None else []
        return recs[-n:]

    def scan_now(self) -> None:
        """Synchronous scan (postmortem capture wants the dead worker's
        final lines in the index before bundling)."""
        self._scan_once()

    # ---- tailing loop ---------------------------------------------------

    def _take_tokens(self, source: str, want: int) -> int:
        """Token-bucket flood control per source; returns how many of
        `want` lines may be published now."""
        if self.rate_lps <= 0:
            return want
        now = time.monotonic()
        tokens, last = self._bucket.get(source, (float(self.burst), now))
        tokens = min(float(self.burst), tokens + (now - last) * self.rate_lps)
        grant = min(want, int(tokens))
        self._bucket[source] = (tokens - grant, now)
        return grant

    def _scan_once(self) -> None:
        if not os.path.isdir(self.log_dir):
            return
        with self._scan_lock:
            for name in sorted(os.listdir(self.log_dir)):
                if not name.endswith(".log"):
                    continue
                path = os.path.join(self.log_dir, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                ino, offset = self._offsets.get(name, (st.st_ino, 0))
                if ino != st.st_ino or st.st_size < offset:
                    # rotated (new inode) or truncated: restart the tail
                    offset = 0
                    ino = st.st_ino
                if st.st_size <= offset:
                    self._offsets[name] = (ino, offset)
                    continue
                try:
                    with open(path, "rb") as f:
                        f.seek(offset)
                        chunk = f.read(st.st_size - offset)
                except OSError:
                    continue
                # only index complete lines; keep the partial tail for
                # the next scan
                last_nl = chunk.rfind(b"\n")
                if last_nl < 0:
                    self._offsets[name] = (ino, offset)
                    continue
                self._offsets[name] = (ino, offset + last_nl + 1)
                lines = chunk[:last_nl].decode(
                    "utf-8", errors="replace").splitlines()
                if not lines:
                    continue
                source = name[:-len(".log")]
                records = self._source_records(source, lines)
                dq = self._tails.get(source)
                if dq is None:
                    dq = self._tails[source] = collections.deque(
                        maxlen=self.tail_lines)
                dq.extend(records)
                self._publish_q.append((source, records))

    def _publish(self, source: str, records: List[Dict[str, Any]]) -> None:
        grant = self._take_tokens(source, len(records))
        dropped = len(records) - grant
        if dropped:
            self.dropped_by_source[source] = \
                self.dropped_by_source.get(source, 0) + dropped
            try:
                from ray_tpu_torch.util.metrics import Counter, get_or_create
                get_or_create(
                    Counter, "ray_tpu_log_lines_dropped_total",
                    description="log lines shed from the driver stream "
                                "by per-source flood control (the tail "
                                "index keeps them)").inc(dropped)
            except Exception:  # noqa: BLE001 - metrics are best-effort
                pass
        published = records[:grant]
        if not published and not dropped:
            return
        try:
            self._gcs.call("publish", channel="worker_logs", message={
                "node_id": self.node_id_hex,
                "worker": source,
                "lines": [r.get("msg", "") for r in published],
                "records": published,
                "dropped": dropped,
                "dropped_total": self.dropped_by_source.get(source, 0),
            })
        except Exception:  # noqa: BLE001
            logger.debug("log publish failed", exc_info=True)

    def _drain_publish(self) -> None:
        """Publish queued batches (single caller at a time: the monitor
        thread, or stop()'s drain after the join — so the token-bucket
        state and per-source ordering stay race-free)."""
        while True:
            with self._scan_lock:
                if not self._publish_q:
                    return
                source, records = self._publish_q.pop(0)
            self._publish(source, records)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self._scan_once()
                self._drain_publish()
            except Exception:  # noqa: BLE001
                logger.debug("log monitor scan failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        # the poll thread shares the index and the GCS client: join it
        # before the final drain so nothing races or double-publishes
        self._thread.join(timeout=5)
        # final drain so lines written just before shutdown still flow
        try:
            self._scan_once()
            self._drain_publish()
        except Exception:  # noqa: BLE001 - final drain is best-effort
            pass
        try:
            self._gcs.close()
        except Exception:  # noqa: BLE001 - closing an already-dead client
            pass
