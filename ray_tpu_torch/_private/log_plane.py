"""Debug plane: attributed structured logs + black-box flight dumps.

reference parity: python/ray/_private/ray_logging (worker stdout/stderr
redirection with task/actor attribution) + log_monitor.py line parsing.
Every line a worker emits — print(), logging, native chatter — is
stamped at WRITE time with the process identity (proc kind/pid), the
currently-executing task id, the hosting actor id, and the active
`util.tracing` trace id, so the log monitor can index it and the
cluster query plane (`ray_tpu logs`, GCS `logs_query`) can filter
server-side without ever re-joining logs to traces by timestamp
(Dapper-style correlation: the trace id IS on the line).

The stamp is a line-oriented prefix, one record per line:

    @rt1 <unix_ts> <kind>/<pid> <task|-> <actor|-> <trace|-> <LEVEL> <msg>

Unstamped lines (native libraries, faulthandler dumps) parse as level
"RAW" records carrying only the message — they still land in the tail
index and the query plane, just without attribution.

Black-box flight dumps: a worker that knows it is about to die hard
(chaos self-kill) writes its span-ring tail + recent log records to a
sidecar file next to its log; the node manager folds it into the crash
postmortem bundle it reports to the GCS (see node_manager.py
`_capture_postmortem`).
"""

from __future__ import annotations

import collections
import io
import json
import logging
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

STAMP = "@rt1"
_STAMP_PREFIX = STAMP + " "

# process identity for stamps; set by install()/init_worker_io()
_kind = "proc"
_tail_ring: "collections.deque" = collections.deque(maxlen=2048)
_context_provider: Optional[Callable[[], tuple]] = None
_worker_io_installed = False
_capture_installed = False
_raw_stderr = None
_lock = threading.Lock()


def set_context_provider(fn: Callable[[], tuple]) -> None:
    """fn() -> (task_id_hex | None, actor_id_hex | None, trace_id | None);
    read at stamp time (must be cheap + never raise)."""
    global _context_provider
    _context_provider = fn


def _context() -> tuple:
    fn = _context_provider
    if fn is None:
        return (None, None, None)
    try:
        return fn()
    except Exception:  # noqa: BLE001 - stamping must never break a write
        return (None, None, None)


def _short(id_hex: Optional[str], n: int = 12) -> str:
    return id_hex[:n] if id_hex else "-"


def format_line(msg: str, level: str,
                ts: Optional[float] = None) -> tuple:
    """(stamped line, parsed record) for one message line."""
    task, actor, trace = _context()
    ts = time.time() if ts is None else ts
    line = (f"{STAMP} {ts:.6f} {_kind}/{os.getpid()} {_short(task)} "
            f"{_short(actor)} {trace or '-'} {level} {msg}")
    rec = {"ts": ts, "kind": _kind, "pid": os.getpid(),
           "task_id": task[:12] if task else None,
           "actor_id": actor[:12] if actor else None,
           "trace_id": trace, "level": level, "msg": msg}
    return line, rec


def parse_line(raw: str) -> Dict[str, Any]:
    """Parse one log-file line back into a record; unstamped lines
    become level-RAW records (native output, faulthandler dumps)."""
    if raw.startswith(_STAMP_PREFIX):
        parts = raw.split(" ", 7)
        if len(parts) >= 7:
            kind, _, pid = parts[2].partition("/")
            try:
                ts: Optional[float] = float(parts[1])
            except ValueError:
                ts = None
            try:
                pid_i: Optional[int] = int(pid)
            except ValueError:
                pid_i = None
            return {"ts": ts, "kind": kind, "pid": pid_i,
                    "task_id": None if parts[3] == "-" else parts[3],
                    "actor_id": None if parts[4] == "-" else parts[4],
                    "trace_id": None if parts[5] == "-" else parts[5],
                    "level": parts[6],
                    "msg": parts[7] if len(parts) > 7 else ""}
    return {"ts": None, "kind": None, "pid": None, "task_id": None,
            "actor_id": None, "trace_id": None, "level": "RAW",
            "msg": raw}


def _ids_match(rec_val: Optional[str], query: str) -> bool:
    """Prefix-tolerant id compare: stamps carry 12-char prefixes while
    callers may pass full hex (or an even shorter prefix)."""
    if not rec_val:
        return False
    n = min(len(rec_val), len(query))
    return n > 0 and rec_val[:n] == query[:n]


def filter_records(records, filters: Optional[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """Server-side record filtering shared by the log monitor tail
    index, the NM snapshot handler, driver snapshots, and follow mode.
    Supported keys: node_id / worker_id / actor_id / task_id (prefix),
    trace_id (exact or prefix), level (exact), match (regex over msg),
    since_ts (float)."""
    if not filters:
        return list(records)
    rx = None
    if filters.get("match"):
        rx = re.compile(filters["match"])
    since = filters.get("since_ts")
    out = []
    for rec in records:
        if filters.get("node_id") and not _ids_match(
                rec.get("node_id"), filters["node_id"]):
            continue
        if filters.get("worker_id") and not _ids_match(
                rec.get("worker_id"), filters["worker_id"]):
            continue
        if filters.get("actor_id") and not _ids_match(
                rec.get("actor_id"), filters["actor_id"]):
            continue
        if filters.get("task_id") and not _ids_match(
                rec.get("task_id"), filters["task_id"]):
            continue
        if filters.get("trace_id") and not _ids_match(
                rec.get("trace_id"), filters["trace_id"]):
            continue
        if filters.get("level") and rec.get("level") != filters["level"]:
            continue
        if since is not None and (rec.get("ts") or 0.0) < since:
            continue
        if rx is not None and not rx.search(rec.get("msg") or ""):
            continue
        out.append(rec)
    return out


# ---------------------------------------------------------------------
# Worker-side stream redirection + logging integration
# ---------------------------------------------------------------------


def _emit(msg: str, level: str, raw) -> None:
    try:
        line, rec = format_line(msg, level)
        _tail_ring.append(rec)
        raw.write(line + "\n")
        raw.flush()
    except Exception:  # noqa: BLE001 - a broken pipe must not kill the
        pass           # writer (the NM reads the file, not the pipe)


class AttributedStream(io.TextIOBase):
    """Line-buffering stdout/stderr wrapper that stamps each COMPLETE
    line with the current task/actor/trace context. Partial lines stay
    buffered until their newline arrives (a stamp mid-line would split
    one print() into two records)."""

    def __init__(self, raw, level: str):
        self._raw = raw
        self._level = level
        self._buf = ""
        # concurrent writers (task thread + RPC handler threads share
        # sys.stdout): an unlocked read-modify-write of the buffer
        # garbles, duplicates, or drops interleaved lines
        self._wlock = threading.Lock()

    def write(self, s: str) -> int:
        if not isinstance(s, str):
            s = str(s)
        with self._wlock:
            self._buf += s
            while "\n" in self._buf:
                line, self._buf = self._buf.split("\n", 1)
                _emit(line, self._level, self._raw)
        return len(s)

    def flush(self) -> None:
        try:
            self._raw.flush()
        except Exception:  # noqa: BLE001 - sink closed mid-flush
            pass

    def fileno(self) -> int:
        return self._raw.fileno()

    def isatty(self) -> bool:
        return False

    @property
    def encoding(self):
        return getattr(self._raw, "encoding", "utf-8")

    @property
    def buffer(self):
        # native writers (np.savetxt, json.dump(fp.buffer)) bypass the
        # stamper; their bytes land unstamped and index as RAW lines
        return self._raw.buffer

    @property
    def name(self):
        return getattr(self._raw, "name", "<attributed>")


class StampedHandler(logging.Handler):
    """Root-logger handler writing stamped lines straight to the RAW
    stream (bypassing the AttributedStream wrapper, so log records carry
    their real level instead of ERR)."""

    def __init__(self, raw):
        super().__init__()
        self._raw = raw

    def emit(self, record: logging.LogRecord) -> None:
        try:
            # keep the logger name (the old worker format carried it)
            text = f"{record.name}: {record.getMessage()}"
            if record.exc_info:
                import traceback as _tb
                text += "\n" + "".join(
                    _tb.format_exception(*record.exc_info)).rstrip()
            for ln in text.splitlines() or [""]:
                _emit(ln, record.levelname, self._raw)
        except Exception:  # noqa: BLE001 - logging must never raise
            pass


class _RingCaptureHandler(logging.Handler):
    """Driver-side capture: record into the in-process tail ring only
    (the driver's console output is untouched)."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            _, rec = format_line(record.getMessage(), record.levelname)
            _tail_ring.append(rec)
        except Exception:  # noqa: BLE001 - must not throw into logging
            pass


def init_worker_io(kind: str = "worker") -> None:
    """Worker-process bootstrap: redirect stdout/stderr through the
    line stamper and route `logging` through a stamped root handler.
    Called once from worker_main before any task runs."""
    global _kind, _worker_io_installed, _raw_stderr
    import sys
    _kind = kind
    _resize_ring()
    raw_out, raw_err = sys.stdout, sys.stderr
    for s in (raw_out, raw_err):
        try:
            s.reconfigure(line_buffering=True)
        except Exception:  # noqa: BLE001 - no reconfigure; default buffering
            pass
    _raw_stderr = raw_err
    sys.stdout = AttributedStream(raw_out, "OUT")
    sys.stderr = AttributedStream(raw_err, "ERR")
    root = logging.getLogger()
    root.handlers[:] = [StampedHandler(raw_err)]
    root.setLevel(logging.INFO)
    _worker_io_installed = True


def install_capture(kind: str = "driver") -> None:
    """Driver-side (or any non-redirected process) logging capture into
    the in-process tail ring, so `ray_tpu logs` also answers for
    drivers. Idempotent; a no-op where init_worker_io already ran."""
    global _kind, _capture_installed
    with _lock:
        if _worker_io_installed or _capture_installed:
            return
        _kind = kind
        _resize_ring()
        logging.getLogger().addHandler(_RingCaptureHandler())
        _capture_installed = True


def _resize_ring() -> None:
    global _tail_ring
    try:
        from ray_tpu_torch._private.config import Config
        n = int(Config.log_tail_lines)
    except Exception:  # noqa: BLE001
        n = 2048
    if _tail_ring.maxlen != n:
        _tail_ring = collections.deque(_tail_ring, maxlen=n)


def raw_stderr():
    """The unwrapped stderr (for faulthandler, which needs a real fd
    and must not deadlock against the stamping wrapper in a signal
    handler)."""
    import sys
    return _raw_stderr or sys.stderr


def tail(n: Optional[int] = None) -> List[Dict[str, Any]]:
    recs = list(_tail_ring)
    return recs[-n:] if n else recs


def snapshot(filters: Optional[Dict[str, Any]] = None,
             tail: Optional[int] = None) -> Dict[str, Any]:
    """This process's in-memory log tail, filtered server-side — the
    `cw_logs_snapshot` gather point of the GCS `logs_query` fan-out
    (drivers live outside any node manager's log dir)."""
    from ray_tpu_torch._private import spans as _spans
    label = _spans.process_label()
    node_id = _spans.process_node_id()
    # attach process identity BEFORE filtering: ring records carry no
    # node/worker ids of their own, so a node- or worker-filtered query
    # would otherwise silently drop every driver record
    recs = []
    for rec in list(_tail_ring):
        rec = dict(rec)
        rec.setdefault("node_id", node_id[:12] if node_id else None)
        rec.setdefault("worker_id", label)
        recs.append(rec)
    recs = filter_records(recs, filters)
    if tail:
        recs = recs[-int(tail):]
    return {"proc_uid": _spans.PROC_UID, "pid": os.getpid(),
            "label": label, "node_id": node_id, "records": recs}


# ---------------------------------------------------------------------
# Black-box flight dumps
# ---------------------------------------------------------------------


def flight_dump_path() -> Optional[str]:
    d = os.environ.get("RAY_TPU_SESSION_DIR")
    wid = os.environ.get("RAY_TPU_WORKER_ID")
    if not d or not wid:
        return None
    return os.path.join(d, "logs", f"worker-{wid[:12]}.flight.json")


def read_rss_bytes(pid: Optional[int] = None) -> Optional[int]:
    try:
        with open(f"/proc/{pid or os.getpid()}/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE")
                                               if hasattr(os, "sysconf")
                                               else 4096)
    except Exception:  # noqa: BLE001 - non-linux / proc gone
        return None


def write_flight_dump(reason: str = "") -> Optional[str]:
    """Persist this process's span-ring tail + recent log records to the
    sidecar file the node manager folds into the crash postmortem. Runs
    on the about-to-die path (chaos self-kill), so it must be quick and
    must never raise."""
    path = flight_dump_path()
    if path is None:
        return None
    try:
        from ray_tpu_torch._private import spans as _spans
        from ray_tpu_torch._private.config import Config
        k = int(Config.postmortem_span_tail)
        dump = {
            "ts": time.time(),
            "reason": reason,
            "pid": os.getpid(),
            "rss_bytes": read_rss_bytes(),
            "span_tail": [list(r) for r in
                          _spans.ring().snapshot_records()[-k:]],
            "log_tail": tail(int(Config.postmortem_log_lines)),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(dump, f, default=str)
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 - dying anyway; best effort
        return None


def consume_flight_dump(log_dir: str,
                        worker_id_hex: str) -> Optional[Dict[str, Any]]:
    """Read-and-delete a dead worker's flight dump (node-manager side)."""
    path = os.path.join(log_dir, f"worker-{worker_id_hex[:12]}.flight.json")
    try:
        with open(path) as f:
            dump = json.load(f)
    except Exception:  # noqa: BLE001 - no dump (SIGKILL'd from outside)
        return None
    try:
        os.unlink(path)
    except OSError:
        pass
    return dump
