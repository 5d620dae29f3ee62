"""Profiling plane: task-attributed CPU flamegraphs for every process.

reference parity: dashboard/modules/reporter/profile_manager.py (the
reference shells out to py-spy/memray per process) + `ray stack`
(scripts.py:1810). Here the sampler is IN-process — a daemon thread over
`sys._current_frames()` — so profiles work with zero external binaries
and carry runtime context no external sampler can see: the task id /
actor id / trace id executing on each sampled thread, read from the
same per-thread context the debug plane's log stamper uses.

The plane has three layers:

  - **Sampler** (this module, per process): start/stop/snapshot around a
    fixed-rate sampling loop; samples aggregate immediately into a
    BOUNDED folded-stack table (function-granularity frames, root
    first), so memory is O(distinct stacks) with an explicit drop
    counter once `Config.profile_max_stacks` distinct stacks exist —
    never O(duration). Each entry is keyed by (thread name, task id,
    actor id, trace id, frames): flamegraphs group by attribution.
  - **Cluster collect** (gcs.profile_collect): one fan-out —
    start→sleep→snapshot on every node manager (which covers its
    workers one hop below) and every pubsub-subscribed driver,
    CONCURRENTLY, under one overall deadline. Merging is clock-free:
    folded stacks carry counts, not timestamps, so skewed clocks
    cannot misalign anything.
  - **Renders**: speedscope JSON (`to_speedscope`) and collapsed
    flamegraph text (`to_folded`, flamegraph.pl format), surfaced as
    `ray_tpu profile`, dashboard /api/profile, util.state.profile().

Overhead contract (asserted in tests/test_profiler.py, same in-situ
methodology as the PR 5 spans bound): while sampling at `hz`, cost is
hz x measured per-sample walk time (< 2% of wall at 100 hz); while
stopped there is NO sampler thread and the only standing cost is the
executor's per-task context-dict write.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple
from ray_tpu_torch.util.locks import TracedLock

# ---------------------------------------------------------------------
# Per-thread execution context (the attribution the sampler stamps)
# ---------------------------------------------------------------------
# threading.local is invisible across threads, so the core worker
# mirrors its TLS here: plain dicts keyed by thread ident. CPython dict
# item assignment is atomic — the executor's set/clear never contends
# with the sampler's reads.
_THREAD_TASK: Dict[int, str] = {}
_THREAD_TRACE: Dict[int, str] = {}
# actor identity is per-process (one actor instance per worker)
_process_actor_id: Optional[str] = None
_process_worker_id: Optional[str] = None


def set_thread_task(task_id_hex: Optional[str]) -> None:
    ident = threading.get_ident()
    if task_id_hex is None:
        _THREAD_TASK.pop(ident, None)
    else:
        _THREAD_TASK[ident] = task_id_hex


def set_thread_trace(trace_id: Optional[str]) -> None:
    ident = threading.get_ident()
    if trace_id is None:
        _THREAD_TRACE.pop(ident, None)
    else:
        _THREAD_TRACE[ident] = trace_id


def set_process_actor(actor_id_hex: Optional[str]) -> None:
    global _process_actor_id
    _process_actor_id = actor_id_hex


def set_process_worker(worker_id_hex: Optional[str]) -> None:
    """Worker identity for `ray_tpu profile --worker` filtering (the
    span-plane label only carries an 8-char prefix)."""
    global _process_worker_id
    _process_worker_id = worker_id_hex


# ---------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------


class Sampler:
    """Fixed-rate stack sampler with bounded folded aggregation.

    One instance per process (module-level `sampler()`); start/stop are
    idempotent-friendly under the collect singleflight. Aggregation
    happens inside the sampling loop — a snapshot is a cheap dict copy,
    not a replay of raw samples.

    Idle threads (top frame parked in a stdlib wait or the RPC layer's
    socket read) are edge-sampled 1-in-IDLE_SAMPLE_K with their counts
    scaled back up: a daemon process is mostly parked threads, and
    walking every one of them every sample is what blows the overhead
    budget (~5µs/thread on this class of box — the same reasoning as
    the span plane's 1-in-16 server-dispatch sampling). Busy threads —
    the ones a profile exists for — are walked every sample.
    """

    MAX_DEPTH = 96
    IDLE_SAMPLE_K = 16
    # a thread whose TOP python frame lives here is parked in a wait
    # primitive (C-level sleeps/recvs don't push a frame, so the
    # caller's stdlib wrapper is what shows)
    _IDLE_FILES = ("threading.py", "queue.py", "selectors.py",
                   "socketserver.py", "ssl.py", "socket.py")
    _IDLE_NAMES = ("_recv_exact",)  # rpc.py socket reads

    def __init__(self, max_stacks: int = 2000):
        self.max_stacks = max(16, int(max_stacks))
        self._lock = TracedLock("profiler")  # start/stop/snapshot control
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()
        self.hz = 0.0
        # (thread_name, task, actor, trace, frames) -> count
        self._stacks: Dict[Tuple, int] = {}
        self.samples_total = 0
        self.dropped = 0          # samples lost to the stack-table cap
        self.sample_cost_s = 0.0  # cumulative in-situ walk time
        # last-256 per-sample walk costs: the overhead bound uses the
        # MEDIAN — a walk preempted mid-flight measures GIL wait (time
        # the workload was actually running), and that preemption tail
        # would otherwise dominate the mean under load
        from collections import deque
        self._cost_ring: "deque" = deque(maxlen=256)
        self._started_mono = 0.0
        self._sampled_wall_s = 0.0
        self._thread_names: Dict[int, str] = {}

    # -- control ------------------------------------------------------

    def start(self, hz: float = 100.0) -> bool:
        """Begin sampling at `hz`; returns False if already running
        (the running session keeps its own rate)."""
        hz = min(1000.0, max(1.0, float(hz)))
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self.hz = hz
            self._stacks = {}
            self.samples_total = 0
            self.dropped = 0
            self.sample_cost_s = 0.0
            self._started_mono = time.monotonic()
            self._sampled_wall_s = 0.0
            self._stop_ev = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, args=(self._stop_ev, hz),
                daemon=True, name="ray-tpu-profiler")
            self._thread.start()
            return True

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            self._stop_ev.set()
            self._thread = None
        if t is not None:
            t.join(timeout=2.0)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- sampling loop ------------------------------------------------

    def _loop(self, stop_ev: threading.Event, hz: float) -> None:
        period = 1.0 / hz
        next_t = time.monotonic()
        while not stop_ev.is_set():
            t0 = time.perf_counter()
            # under the control lock: snapshot() iterates the stacks
            # table and the cost ring, and an unlocked insert mid-copy
            # raises "changed size during iteration", losing the whole
            # profile. Contention is one rare snapshot per collect, so
            # the lock costs an uncontended acquire per sample.
            with self._lock:
                try:
                    self._sample_once()
                except Exception:  # noqa: BLE001 - a torn frame walk
                    pass           # loses one sample, never the sampler
                cost = time.perf_counter() - t0
                self.sample_cost_s += cost
                self._cost_ring.append(cost)
                self.samples_total += 1
            next_t += period
            delay = next_t - time.monotonic()
            if delay > 0:
                stop_ev.wait(delay)
            else:
                # behind schedule (GIL-starved): resynchronize instead
                # of bursting to catch up — the rate is a ceiling
                next_t = time.monotonic()
        with self._lock:
            self._sampled_wall_s += time.monotonic() - self._started_mono

    def _thread_name(self, ident: int) -> str:
        name = self._thread_names.get(ident)
        if name is None:
            self._thread_names = {
                t.ident: t.name for t in threading.enumerate()
                if t.ident is not None}
            name = self._thread_names.get(ident)
            if name is None:
                # foreign/C-created thread: CACHE the fallback, or this
                # rebuild would repeat every sample for the whole
                # session (exactly the walk cost the overhead budgets)
                name = f"thread-{ident}"
                self._thread_names[ident] = name
        return name

    def _sample_once(self) -> None:
        own = threading.get_ident()
        actor = _process_actor_id
        tick = self.samples_total
        idle_round = tick % self.IDLE_SAMPLE_K == 0
        for ident, top in sys._current_frames().items():
            if ident == own:
                continue
            code = top.f_code
            idle = (code.co_filename.endswith(self._IDLE_FILES)
                    or code.co_name in self._IDLE_NAMES)
            if idle and not idle_round:
                continue
            weight = self.IDLE_SAMPLE_K if idle else 1
            frames: List[Tuple[str, str, int]] = []
            f = top
            depth = 0
            while f is not None and depth < self.MAX_DEPTH:
                code = f.f_code
                frames.append((code.co_name, code.co_filename,
                               code.co_firstlineno))
                f = f.f_back
                depth += 1
            frames.reverse()  # root first (folded/speedscope order)
            key = (self._thread_name(ident), _THREAD_TASK.get(ident),
                   actor, _THREAD_TRACE.get(ident), tuple(frames))
            n = self._stacks.get(key)
            if n is not None:
                self._stacks[key] = n + weight
            elif len(self._stacks) < self.max_stacks:
                self._stacks[key] = weight
            else:
                self.dropped += 1

    # -- snapshot -----------------------------------------------------

    def snapshot(self, reset: bool = False) -> Dict[str, Any]:
        """This process's aggregated profile (wire form). `reset=True`
        atomically hands the aggregation table over, so back-to-back
        collects don't double-count."""
        from ray_tpu_torch._private import spans as spans_lib
        with self._lock:
            running = self.running
            stacks = self._stacks
            sampled_s = self._sampled_wall_s
            if running:
                sampled_s += time.monotonic() - self._started_mono
            out = {
                "proc_uid": spans_lib.PROC_UID,
                "pid": os.getpid(),
                "label": spans_lib.process_label(),
                "node_id": spans_lib.process_node_id(),
                "worker_id": _process_worker_id,
                "actor_id": _process_actor_id,
                "hz": self.hz,
                "running": running,
                "duration_s": sampled_s,
                "samples": self.samples_total,
                "dropped": self.dropped,
                "sample_cost_s": self.sample_cost_s,
                "sample_cost_p50_s": (
                    sorted(self._cost_ring)[len(self._cost_ring) // 2]
                    if self._cost_ring else 0.0),
                "stacks": [
                    {"thread": thr, "task_id": task, "actor_id": act,
                     "trace_id": trace,
                     "frames": [list(fr) for fr in frames],
                     "count": count}
                    for (thr, task, act, trace, frames), count
                    in stacks.items()],
            }
            if reset:
                self._stacks = {}
        return out


_SAMPLER: Optional[Sampler] = None
_SAMPLER_LOCK = threading.Lock()


def sampler() -> Sampler:
    global _SAMPLER
    with _SAMPLER_LOCK:
        if _SAMPLER is None:
            from ray_tpu_torch._private.config import Config
            _SAMPLER = Sampler(max_stacks=Config.profile_max_stacks)
        return _SAMPLER


# ---------------------------------------------------------------------
# Local collect (start → sleep → snapshot), singleflight
# ---------------------------------------------------------------------

# The cluster fan-out can reach one process twice (its node manager's
# worker gather AND the GCS's direct subscriber pull run concurrently):
# the first arrival runs the session, later arrivals wait for it and
# share its result, so a process is never double-sampled.
_collect_cv = threading.Condition()
_collect_running = False
_collect_gen = 0
_collect_result: Optional[Dict[str, Any]] = None


def collect_local(duration_s: float = 5.0,
                  hz: float = 100.0) -> Dict[str, Any]:
    global _collect_running, _collect_gen, _collect_result
    duration_s = min(120.0, max(0.05, float(duration_s)))
    with _collect_cv:
        if _collect_running:
            gen = _collect_gen
            _collect_cv.wait_for(lambda: _collect_gen != gen,
                                 timeout=duration_s + 10.0)
            if _collect_result is not None:
                return _collect_result
            # the in-flight session wedged; fall through and sample
        _collect_running = True
    s = sampler()
    started_here = s.start(hz)
    prof: Optional[Dict[str, Any]] = None
    try:
        time.sleep(duration_s)
        prof = s.snapshot(reset=True)
    finally:
        if started_here:
            s.stop()
        with _collect_cv:
            _collect_running = False
            _collect_gen += 1
            _collect_result = prof
            _collect_cv.notify_all()
    if prof is None:  # unreachable unless sleep/snapshot raised
        raise RuntimeError("profile collect failed")
    return prof


# ---------------------------------------------------------------------
# Device mode (torch.profiler traces via util.gpu_profiler)
# ---------------------------------------------------------------------


# The fan-out can reach a process twice, as in collect_local; two
# torch.profiler sessions at once are two CUPTI subscribers, which the
# CUDA profiling API refuses (and a process has died of). The first
# arrival traces; later ones wait for it and share its report.
_device_lock = threading.Lock()
_device_session: Optional[Dict[str, Any]] = None


def device_export_s(duration_s: float) -> float:
    """Time a device trace may take to be written out after a window of
    `duration_s`, which the collect's deadlines add in device mode: a
    deadline of the window plus the CPU sampler's grace drops a busy
    process's trace whose export outlasts it. The export grows with what
    the window recorded: a GPT-2-125M training loop on an H100 (~23 MiB
    of trace a window second) answered 7.46, 21.18 and 59.29 s after
    windows of 2, 10 and 30 s (chip_profile_export.py), under the line
    3.8 + 1.85 s a window second; this allows about twice that line.
    Windows above 30 s (up to the 120 s cap) are unmeasured."""
    return 10.0 + 4.0 * duration_s


def device_profile(duration_s: float = 5.0,
                   log_dir: Optional[str] = None) -> Dict[str, Any]:
    """`ray_tpu profile --device`: run a torch.profiler trace (CPU and
    CUDA activities) on this process for `duration_s` and report its
    directory under `xplane_dir`, the key the JAX package's callers
    read (it holds a Chrome trace here, not xplane). Only processes that
    already initialized CUDA participate — initializing it here would
    claim a card out from under the workload."""
    global _device_session
    from ray_tpu_torch._private import spans as spans_lib
    base = {"proc_uid": spans_lib.PROC_UID, "pid": os.getpid(),
            "label": spans_lib.process_label(),
            "node_id": spans_lib.process_node_id(),
            "worker_id": _process_worker_id,
            "actor_id": _process_actor_id}
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return {**base, "skipped": "CUDA not initialized in this process"}
    duration_s = min(120.0, max(0.05, float(duration_s)))
    with _device_lock:
        session = _device_session
        if session is None:
            session = _device_session = {"done": threading.Event(),
                                         "report": None}
            owner = True
        else:
            owner = False
    if not owner:
        session["done"].wait(duration_s + 60.0)
        return session["report"] or {
            **base, "error": "a concurrent device trace did not finish"}
    report = None
    try:
        import tempfile

        from ray_tpu_torch.util import gpu_profiler
        log_dir = log_dir or os.path.join(
            tempfile.gettempdir(),
            f"ray_tpu_trace_{os.getpid()}_{int(time.time())}")
        with gpu_profiler.trace(log_dir):
            time.sleep(duration_s)
        report = {**base, "xplane_dir": log_dir,
                  "devices": [torch.cuda.get_device_name(i)
                              for i in range(torch.cuda.device_count())]}
    except Exception as e:  # noqa: BLE001 - report, don't kill the fan-out
        report = {**base, "error": f"{type(e).__name__}: {e}"}
    finally:
        session["report"] = report
        session["done"].set()
        with _device_lock:
            _device_session = None
    return report


# ---------------------------------------------------------------------
# Merge + renders (clock-free: counts, not timestamps)
# ---------------------------------------------------------------------


def _attr_frames(stack: Dict[str, Any]) -> List[Tuple[str, str, int]]:
    """Synthetic root frames carrying the attribution, so flamegraphs
    group by thread → actor → task → trace before any code frame."""
    out: List[Tuple[str, str, int]] = [
        (f"thread:{stack.get('thread') or '?'}", "", 0)]
    if stack.get("actor_id"):
        out.append((f"actor:{stack['actor_id'][:12]}", "", 0))
    if stack.get("task_id"):
        out.append((f"task:{stack['task_id'][:12]}", "", 0))
    if stack.get("trace_id"):
        out.append((f"trace:{stack['trace_id']}", "", 0))
    return out


def filter_profiles(profiles: List[Dict[str, Any]],
                    node_id: Optional[str] = None,
                    worker_id: Optional[str] = None,
                    actor_id: Optional[str] = None,
                    trace_id: Optional[str] = None
                    ) -> List[Dict[str, Any]]:
    """Client-side selection for the CLI's --node/--worker/--actor/
    --trace-id modes; node/worker/actor ids match by prefix."""
    out: List[Dict[str, Any]] = []
    for p in profiles:
        if node_id and not str(p.get("node_id") or "").startswith(node_id):
            continue
        if worker_id and not str(p.get("worker_id") or "").startswith(
                worker_id):
            continue
        if actor_id and not (
                str(p.get("actor_id") or "").startswith(actor_id)
                or any(str(s.get("actor_id") or "").startswith(actor_id)
                       for s in p.get("stacks", ()))):
            continue
        if trace_id:
            stacks = [s for s in p.get("stacks", ())
                      if s.get("trace_id") == trace_id]
            if not stacks:
                continue
            p = {**p, "stacks": stacks}
        out.append(p)
    return out


def _frame_label(name: str, path: str, line: int) -> str:
    if not path:
        return name
    short = "/".join(path.split("/")[-2:])
    return f"{name} ({short}:{line})"


def to_folded(profiles: List[Dict[str, Any]]) -> str:
    """Collapsed flamegraph.pl format: one `a;b;c count` line per
    distinct stack, cluster-merged (identical lines from different
    sampling windows sum)."""
    agg: Dict[str, int] = {}
    for p in profiles:
        label = p.get("label") or f"proc-{p.get('pid')}"
        for s in p.get("stacks", ()):
            parts = [label]
            parts.extend(n for n, _f, _l in _attr_frames(s))
            parts.extend(_frame_label(*fr) for fr in s["frames"])
            line = ";".join(x.replace(";", ",") for x in parts)
            agg[line] = agg.get(line, 0) + int(s["count"])
    return "\n".join(f"{line} {count}"
                     for line, count in sorted(agg.items())) + "\n"


def to_speedscope(profiles: List[Dict[str, Any]],
                  name: str = "ray_tpu profile") -> Dict[str, Any]:
    """One speedscope file for the whole cluster: a shared frame table
    and one "sampled" profile per process (pick processes in the
    speedscope UI's profile selector). Weights are sample counts
    (unit "none") — the merge is clock-free by construction."""
    frames: List[Dict[str, Any]] = []
    frame_index: Dict[Tuple[str, str, int], int] = {}

    def fidx(fr: Tuple[str, str, int]) -> int:
        i = frame_index.get(fr)
        if i is None:
            i = len(frames)
            frame_index[fr] = i
            rec: Dict[str, Any] = {"name": _frame_label(*fr)}
            if fr[1]:
                rec["file"] = fr[1]
                rec["line"] = fr[2]
            frames.append(rec)
        return i

    out_profiles: List[Dict[str, Any]] = []
    for p in profiles:
        samples: List[List[int]] = []
        weights: List[int] = []
        for s in p.get("stacks", ()):
            stack = [fidx(fr) for fr in _attr_frames(s)]
            stack.extend(fidx((n, f, int(l))) for n, f, l in s["frames"])
            samples.append(stack)
            weights.append(int(s["count"]))
        total = sum(weights)
        label = p.get("label") or f"proc-{p.get('pid')}"
        if p.get("node_id"):
            label = f"{label}@{str(p['node_id'])[:8]}"
        out_profiles.append({
            "type": "sampled",
            "name": f"{label} ({p.get('samples', total)} samples @ "
                    f"{p.get('hz', 0):g}hz)",
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        })
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "ray_tpu",
        "shared": {"frames": frames},
        "profiles": out_profiles,
    }
