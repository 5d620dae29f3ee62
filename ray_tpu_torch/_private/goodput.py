"""Per-job goodput/badput wall-time ledger.

The TPU-fleet "Goodput" discipline: every second of a training job's
gang lifetime is bucketed into exactly one of BUCKETS, always-on, so
`of the last hour of wall time, how much trained the model?` has a
first-class answer. The driver-side training loops (backend_executor
result rounds, LearnerGroup.update, the IMPALA/DQN learner threads)
bind a ledger to their thread and wrap their phases in `bucket(...)`
scopes; cross-cutting signals that already exist re-attribute time
INSIDE an open scope instead of adding new timers:

  - the jax sentinel's backend-compile duration event charges
    `compile` against the open window (util/jax_sentinel.py fires it
    synchronously on the jit-calling thread),
  - DeviceFeed.get charges its blocked wait to `feed_stall` /
    `replay_stall` (rllib/utils/device_feed.py),
  - elastic re-forms open `elastic_reconfig` / `wedge_recovery` for
    the whole drain->reform->resume window (train/elastic.py).

Accounting invariant: per job, sum(bucket seconds) == wall time since
the ledger was created (to clock precision). Unattributed time is
`idle` — which is why graftlint RT024 flags bare sleeps inside
instrumented loops: they read as phantom idle.

Export: the harvest sampler flushes per-bucket deltas into
`ray_tpu_goodput_seconds_total{job,bucket}` (rides the normal metrics
fan-out, lands in the durable history tiers), and a snapshot extra
carries the in-flight bucket + lifetime totals per job so a forced
`ray_tpu goodput` sees sub-harvest state.

Buckets nest innermost-wins (a checkpoint_save inside a productive
window attributes to checkpoint_save). `charge()` re-attribution is
borrow-based: the charged seconds are deducted from the enclosing
window when it next advances, so wall time is conserved.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

PRODUCTIVE = "productive_step"

BUCKETS = (
    PRODUCTIVE,
    "compile",
    "checkpoint_save",
    "checkpoint_restore",
    "elastic_reconfig",
    "wedge_recovery",
    "feed_stall",
    "replay_stall",
    "idle",
)

METRIC = "ray_tpu_goodput_seconds_total"
SNAPSHOT_KEY = "goodput"

_tls = threading.local()

_registry_lock = threading.Lock()
_LEDGERS: Dict[str, "GoodputLedger"] = {}
_hooks_registered = False
_counter: Any = None


class GoodputLedger:
    """Wall-time classifier for one job.

    Thread model: one *driving* thread owns the bucket stack (the loop
    that binds the ledger); `charge()` may be called from any thread
    holding the same ledger binding (sentinel compile events fire on
    the jit-calling thread, which IS the driving thread). A plain lock
    — not TracedLock — guards state: this sits inside the step hot
    path and must stay nanoseconds-cheap.
    """

    def __init__(self, job: str, time_fn=time.monotonic):
        self.job = job
        self._now = time_fn
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._stack: List[str] = []
        self._mark = self._now()
        self._born = self._mark
        # seconds already charge()d against the open window: deducted
        # from the next advance so wall time is conserved
        self._borrowed = 0.0
        self._exported: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        # when the current stack top (or idle) became the attribution
        # target — purely informational (snapshot bucket_age_s)
        self._top_since = self._mark

    # -- core accounting ----------------------------------------------

    def _advance_locked(self, now: float) -> None:
        dt = now - self._mark
        if dt > 0.0:
            borrow = min(self._borrowed, dt)
            dt -= borrow
            self._borrowed -= borrow
            if dt > 0.0:
                top = self._stack[-1] if self._stack else "idle"
                self._totals[top] = self._totals.get(top, 0.0) + dt
        self._mark = now

    def push(self, name: str) -> None:
        now = self._now()
        with self._lock:
            self._advance_locked(now)
            self._stack.append(name)
            self._top_since = now

    def pop(self, name: str) -> None:
        now = self._now()
        with self._lock:
            self._advance_locked(now)
            if self._stack and self._stack[-1] == name:
                self._stack.pop()
                self._top_since = now
            elif name in self._stack:
                # unbalanced exit (an exception skipped inner pops):
                # unwind through the matching entry
                while self._stack:
                    if self._stack.pop() == name:
                        break
                self._top_since = now

    @contextmanager
    def bucket(self, name: str) -> Iterator[None]:
        self.push(name)
        try:
            yield
        finally:
            self.pop(name)

    def charge(self, name: str, seconds: float) -> None:
        """Attribute `seconds` of already-elapsed wall time to `name`,
        borrowing them back from the enclosing window. Clamped to the
        unaccounted span so a mis-measured duration can never mint
        time that didn't pass."""
        if seconds <= 0.0:
            return
        now = self._now()
        with self._lock:
            avail = max(0.0, now - self._mark - self._borrowed)
            dt = min(float(seconds), avail)
            if dt <= 0.0:
                return
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._borrowed += dt

    # -- views ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        now = self._now()
        with self._lock:
            self._advance_locked(now)
            return {
                "job": self.job,
                "bucket": self._stack[-1] if self._stack else "idle",
                "bucket_age_s": max(0.0, now - self._top_since),
                "uptime_s": now - self._born,
                "totals": {b: round(v, 6)
                           for b, v in self._totals.items() if v > 0.0},
            }

    def totals(self) -> Dict[str, float]:
        now = self._now()
        with self._lock:
            self._advance_locked(now)
            return dict(self._totals)

    def flush_deltas(self) -> Dict[str, float]:
        """Per-bucket seconds accrued since the last flush (harvest
        sampler feed for the monotone counter)."""
        now = self._now()
        with self._lock:
            self._advance_locked(now)
            out = {}
            for b, v in self._totals.items():
                d = v - self._exported.get(b, 0.0)
                if d > 1e-9:
                    out[b] = d
                    self._exported[b] = v
            return out

    # -- thread binding ------------------------------------------------

    def bind(self) -> "GoodputLedger":
        """Make this ledger the current thread's ledger (the thread
        whose bucket()/charge() calls should land here)."""
        _tls.ledger = self
        return self


# ---------------------------------------------------------------------
# Module-level API: call sites never hold a ledger reference
# ---------------------------------------------------------------------


def ledger(job: str, time_fn=time.monotonic) -> GoodputLedger:
    """Get-or-create the process-wide ledger for `job` and register
    the harvest hooks on first use."""
    with _registry_lock:
        led = _LEDGERS.get(job)
        if led is None:
            led = _LEDGERS[job] = GoodputLedger(job, time_fn=time_fn)
        _register_hooks()
        return led


def current() -> Optional[GoodputLedger]:
    return getattr(_tls, "ledger", None)


def unbind() -> None:
    _tls.ledger = None


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP = _NoopCtx()


def bucket(name: str):
    """Bucket scope on the current thread's ledger; shared no-op when
    no ledger is bound (library code can instrument unconditionally)."""
    led = current()
    if led is None:
        return _NOOP
    return led.bucket(name)


def charge(name: str, seconds: float) -> None:
    """Re-attribute elapsed seconds on the current thread's ledger
    (no-op unbound)."""
    led = current()
    if led is not None:
        led.charge(name, seconds)


def enter(name: str) -> Optional[Tuple[GoodputLedger, str]]:
    """Open a bucket without a lexical scope (elastic re-forms open on
    detect, close on finish/abort). Returns an opaque token for
    exit()."""
    led = current()
    if led is None:
        return None
    led.push(name)
    return (led, name)


def exit(token: Optional[Tuple[GoodputLedger, str]]) -> None:  # noqa: A001
    if token is not None:
        token[0].pop(token[1])


def summary() -> Dict[str, Any]:
    """Per-job lifetime bucket totals + productive fraction from THIS
    process's ledgers (the bench tools embed this in their JSON so a
    run's goodput rides along with its throughput numbers; the
    cluster-wide view is util.state.goodput())."""
    with _registry_lock:
        ledgers = list(_LEDGERS.values())
    out: Dict[str, Any] = {}
    for led in ledgers:
        totals = led.totals()
        acc = sum(totals.values())
        out[led.job] = {
            "buckets": {b: round(v, 3)
                        for b, v in totals.items() if v > 1e-3},
            "accounted_s": round(acc, 3),
            "productive_frac": round(totals.get(PRODUCTIVE, 0.0) / acc,
                                     4) if acc > 0 else None,
        }
    return out


# ---------------------------------------------------------------------
# Harvest integration
# ---------------------------------------------------------------------


def _register_hooks() -> None:
    global _hooks_registered, _counter
    if _hooks_registered:
        return
    from ray_tpu_torch._private import metrics_plane
    from ray_tpu_torch.util.metrics import Counter, get_or_create
    _counter = get_or_create(
        Counter, METRIC,
        description="wall seconds of gang lifetime by goodput bucket "
                    "(productive_step is goodput; everything else is "
                    "badput — see README 'Goodput & metrics history')",
        tag_keys=("job", "bucket"))
    metrics_plane.register_sampler("goodput", _sample)
    metrics_plane.register_snapshot_extra(SNAPSHOT_KEY, _snapshot_extra)
    _hooks_registered = True


def _sample() -> None:
    with _registry_lock:
        ledgers = list(_LEDGERS.values())
    for led in ledgers:
        for b, d in led.flush_deltas().items():
            _counter.inc(d, tags={"job": led.job, "bucket": b})


def _snapshot_extra() -> Dict[str, Any]:
    with _registry_lock:
        ledgers = list(_LEDGERS.values())
    return {"jobs": {led.job: led.snapshot() for led in ledgers}}


def _reset_for_tests() -> None:
    global _hooks_registered, _counter
    with _registry_lock:
        _LEDGERS.clear()
        _hooks_registered = False
        _counter = None
    _tls.ledger = None
