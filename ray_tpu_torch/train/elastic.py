"""Elastic reconfiguration plane: shared bookkeeping for gang re-forms.

Used by train/backend_executor.py (JaxTrainer / DataParallelTrainer
gangs) and rllib/core/learner_group.py (mesh learner gangs). One
reconfiguration = the span sequence

    elastic.detect -> elastic.drain -> elastic.checkpoint ->
    elastic.reform -> elastic.reshard -> elastic.resume

recorded on the driver's flight-recorder ring (so `ray_tpu timeline
--spans` shows the full cost breakdown and tools/perf_report.py
attributes it into the `elastic_reconfig` bucket), plus

    ray_tpu_elastic_reconfigurations_total{reason}   counter
    ray_tpu_elastic_reconfig_seconds                 histogram

on the cluster metrics plane. While a reconfiguration is in flight the
tracker's phase + age ride every metrics harvest as the "elastic"
snapshot extra; the GCS watchdog's `elastic_stuck_reconfig` probe
alerts when one has been stuck past Config.watchdog_elastic_reconfig_s
(a gang that can neither re-form nor fail is the worst failure mode —
it looks exactly like training, minus the progress).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import spans

# every reconfiguration walks these phases in order
PHASES = ("detect", "drain", "checkpoint", "reform", "reshard", "resume")


def free_port() -> int:
    """A fresh OS-assigned port for a gang coordinator rendezvous
    (shared by the train and learner gang planes; each formation picks
    a new one so re-forms never collide with a TIME_WAIT socket)."""
    from ray_tpu_torch._private.rpc import find_free_port
    return find_free_port()


def gang_runtime_env(key: str) -> Dict[str, Any]:
    """Runtime env for one gang formation's fresh worker processes.

    jax.distributed must initialize before any other jax use in the
    process, which reused pool workers cannot guarantee — the unique
    value under `key` gives each formation its own worker-pool bucket.
    One host CPU device per gang process: the virtual-device test flag
    (--xla_force_host_platform_device_count=8) would otherwise leak in
    and force per-process shard sizes to be divisible by 8; any other
    XLA_FLAGS the operator set (TPU tuning flags etc.) are preserved.
    Shared by the train gang (jax_backend) and the learner gang
    (rllib/core/learner_group)."""
    import os
    import re
    import uuid
    flags = re.sub(r"--xla_force_host_platform_device_count=\S+", "",
                   os.environ.get("XLA_FLAGS", "")).strip()
    return {"env_vars": {
        key: uuid.uuid4().hex,
        "XLA_FLAGS": (flags + " "
                      "--xla_force_host_platform_device_count=1").strip(),
    }}


def _metrics():
    from ray_tpu_torch.util.metrics import Counter, Histogram, get_or_create
    counter = get_or_create(
        Counter, "ray_tpu_elastic_reconfigurations_total",
        description="completed elastic gang reconfigurations",
        tag_keys=("reason",))
    hist = get_or_create(
        Histogram, "ray_tpu_elastic_reconfig_seconds",
        description="wall time of one elastic reconfiguration "
                    "(detect through resume)",
        boundaries=[0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0])
    return counter, hist


class ReconfigTracker:
    """Phase/metrics/span bookkeeping for ONE gang's reconfigurations.

    Usage:
        rec = tracker.start(reason="worker_death", world_size=4)
        with rec.phase("drain"):
            ...
        ...
        rec.finish(world_size=3)        # success: metrics + history
        # or rec.abort(error)           # failure: state cleared, no count

    The tracker registers itself as an `elastic:*` metrics snapshot
    extra under a per-INSTANCE key so in-flight phase + age are visible
    to the watchdog: two same-named gangs in one driver (e.g. two
    concurrent fit() calls) each stay visible, and one tracker's
    close() can never deregister the other.
    """

    def __init__(self, name: str = "train"):
        import uuid
        self.name = name
        self._extra_key = f"elastic:{name}:{uuid.uuid4().hex[:8]}"
        self._lock = threading.Lock()
        self._counter, self._hist = _metrics()
        self.reconfigs_total = 0
        self.history: List[Dict[str, Any]] = []
        self._current: Optional[Dict[str, Any]] = None
        from ray_tpu_torch._private import metrics_plane
        metrics_plane.register_snapshot_extra(
            self._extra_key, self.snapshot)

    def close(self) -> None:
        from ray_tpu_torch._private import metrics_plane
        metrics_plane.unregister_snapshot_extra(self._extra_key)

    # ---- one reconfiguration ----------------------------------------
    def start(self, reason: str, world_size: int) -> "_Reconfig":
        rec = _Reconfig(self, reason, world_size)
        with self._lock:
            self._current = rec.state
        return rec

    def _finished(self, rec: "_Reconfig", ok: bool) -> None:
        with self._lock:
            if self._current is rec.state:
                self._current = None
            if ok:
                self.reconfigs_total += 1
                self.history.append({
                    "reason": rec.reason,
                    "from_world_size": rec.from_world,
                    "to_world_size": rec.to_world,
                    "duration_s": round(rec.duration_s, 3),
                    "phases_s": {k: round(v, 3)
                                 for k, v in rec.phase_seconds.items()},
                    "ts": time.time(),
                })
                del self.history[:-64]
        if ok:
            self._counter.inc(tags={"reason": rec.reason})
            self._hist.observe(rec.duration_s)

    # ---- watchdog-facing snapshot -----------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            cur = self._current
            out: Dict[str, Any] = {
                "gang": self.name,
                "reconfigs_total": self.reconfigs_total,
                "in_progress": cur is not None,
            }
            if cur is not None:
                out["reason"] = cur["reason"]
                out["phase"] = cur["phase"]
                out["age_s"] = round(
                    time.monotonic() - cur["started_mono"], 3)
            return out


class _Reconfig:
    def __init__(self, tracker: ReconfigTracker, reason: str,
                 world_size: int):
        self.tracker = tracker
        self.reason = reason
        self.from_world = world_size
        self.to_world: Optional[int] = None
        self._t0 = time.monotonic()
        self.duration_s = 0.0
        self.phase_seconds: Dict[str, float] = {}
        self.state: Dict[str, Any] = {
            "reason": reason, "phase": "detect",
            "started_mono": self._t0,
        }
        # goodput: the whole detect->resume window is badput on the
        # driver's ledger — wedge recoveries get their own bucket so
        # churn and hangs stay distinguishable in the ledger
        from ray_tpu_torch._private import goodput
        self._goodput_token = goodput.enter(
            "wedge_recovery" if reason == "wedge"
            else "elastic_reconfig")
        spans.instant("elastic.detect", reason=reason,
                      gang=tracker.name, world_size=world_size)

    def phase(self, name: str, **attrs: Any):
        """Span-recording context manager for one phase; also updates
        the watchdog-visible state."""
        assert name in PHASES, name
        self.state["phase"] = name
        return _Phase(self, name, attrs)

    def finish(self, world_size: int) -> None:
        from ray_tpu_torch._private import goodput
        goodput.exit(self._goodput_token)
        self._goodput_token = None
        self.to_world = world_size
        self.duration_s = time.monotonic() - self._t0
        spans.instant("elastic.resumed", reason=self.reason,
                      gang=self.tracker.name, world_size=world_size,
                      duration_s=round(self.duration_s, 3))
        self.tracker._finished(self, ok=True)

    def abort(self, error: Optional[BaseException] = None) -> None:
        from ray_tpu_torch._private import goodput
        goodput.exit(self._goodput_token)
        self._goodput_token = None
        self.duration_s = time.monotonic() - self._t0
        spans.instant("elastic.aborted", reason=self.reason,
                      gang=self.tracker.name,
                      error=repr(error) if error else "")
        self.tracker._finished(self, ok=False)


class _Phase:
    def __init__(self, rec: _Reconfig, name: str, attrs: Dict[str, Any]):
        self.rec = rec
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._t0 = time.monotonic()
        self._sp = spans.start_span(
            f"elastic.{self.name}", reason=self.rec.reason,
            gang=self.rec.tracker.name, **self.attrs)
        return self._sp.attrs if self._sp is not None else {}

    def __exit__(self, exc_type, exc, tb):
        spans.finish_span(self._sp)
        self.rec.phase_seconds[self.name] = \
            self.rec.phase_seconds.get(self.name, 0.0) \
            + (time.monotonic() - self._t0)
        return False


class MembershipWatch:
    """Driver-side subscription to gang-membership signals: autoscaler
    v2 lifecycle events ("autoscaler_lifecycle" pubsub) and GCS node
    ALIVE/DEAD pushes ("node" pubsub). Callbacks only set flags — the
    reconfiguration itself runs on the training driver thread at the
    next step boundary (reconfiguring from inside a pubsub callback
    would race the result loop)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tokens: List[tuple] = []
        self._capacity_event = False
        self._lost_nodes: List[str] = []
        self._watch_nodes: frozenset = frozenset()

    def subscribe(self) -> None:
        cw = _core_worker_or_none()
        if cw is None:
            return
        # record tokens one at a time: if the SECOND subscribe fails,
        # the first must stay tracked so unsubscribe() can still tear
        # it down (a discarded token leaves the GCS pushing lifecycle
        # events to this driver forever)
        for channel, cb in (("autoscaler_lifecycle", self._on_lifecycle),
                            ("node", self._on_node)):
            try:
                self._tokens.append((channel, cw.subscribe(channel, cb)))
            except Exception:  # noqa: BLE001 - no GCS (unit tests): the
                # reconfig loop still works off probe polling + failures
                break

    def unsubscribe(self) -> None:
        cw = _core_worker_or_none()
        for channel, token in self._tokens:
            try:
                if cw is not None:
                    cw.unsubscribe(channel, token)
            except Exception:  # noqa: BLE001 - GCS gone; sub dies with it
                pass
        self._tokens = []

    def watch_nodes(self, node_ids: List[str]) -> None:
        """The node set whose death means 'a gang member's host is
        gone' (set after every formation)."""
        with self._lock:
            self._watch_nodes = frozenset(node_ids)

    # ---- pubsub callbacks -------------------------------------------
    def _on_lifecycle(self, evt: Any) -> None:
        try:
            to = evt.get("to")
        except Exception:  # noqa: BLE001 - foreign message shape
            return
        if to == "RAY_RUNNING":
            with self._lock:
                self._capacity_event = True

    def _on_node(self, msg: Any) -> None:
        try:
            kind, info = msg
            node_id = info.node_id.hex()
        except Exception:  # noqa: BLE001 - foreign message shape
            return
        with self._lock:
            if kind == "ALIVE":
                self._capacity_event = True
            elif kind == "DEAD" and node_id in self._watch_nodes:
                self._lost_nodes.append(node_id)

    # ---- driver-side polls ------------------------------------------
    def take_capacity_event(self) -> bool:
        with self._lock:
            hit, self._capacity_event = self._capacity_event, False
            return hit

    def take_lost_nodes(self) -> List[str]:
        with self._lock:
            lost, self._lost_nodes = self._lost_nodes, []
            return lost


def _core_worker_or_none():
    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod.global_worker_or_none()
    return None if w is None else w.core_worker
