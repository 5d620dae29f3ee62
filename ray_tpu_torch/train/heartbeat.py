"""Gang heartbeat plane: rank liveness + step deadlines (ISSUE 17).

A rank that wedges *inside* an XLA collective — SIGSTOP'd, GIL-stalled,
or spinning on a partitioned DCN link — blocks every other rank forever
while looking exactly like a long step from the driver. The membership
plane (GCS node/lifecycle pubsub) never fires because nothing died.

The detection loop this module powers:

- **HeartbeatSender** (worker side): a sidecar daemon thread that stamps
  ``(step, phase, monotonic receipt)`` into the GCS ``gang_heartbeat``
  table on a short period. It owns its OWN RpcClient — the core worker's
  client is lock-serialized behind the main thread, which is exactly the
  thread that is stuck in the collective. A SIGSTOP freezes every thread
  including this one, so a *stale* heartbeat (not a dead connection) is
  the wedge signal.
- **StepDeadline** (driver side): per-step deadline, either explicit
  (``ScalingConfig.step_deadline_s``) or auto-calibrated as
  ``k x trailing-p99`` of observed step times so slow-but-alive steps
  never false-trip. Runtime-tunable: ``metrics_configure(
  step_deadline_s=...)`` plants an override the GCS hands back with
  every heartbeat query.
- **classify_wedge / hard_kill_ranks** (driver side): slice-aware
  classification (every rank of one node wedging reads as a slice
  leave, not N independent failures) and the hard-kill actuator. A
  SIGSTOP'd rank cannot run cleanup and the normal ``ray_tpu_torch.kill``
  path RPCs the victim (``cw_kill_self``) — which hangs on a stopped
  process — so the kill goes to the victim's *node manager* instead
  (``nm_kill_worker_pid``: postmortem capture + SIGKILL, which Linux
  delivers to stopped processes).

The trip condition is deliberately two-factor: the step deadline must
have expired AND at least one rank's heartbeat must be stale. A slow
step with every rank still beating keeps waiting; a stale rank before
the deadline is merely suspicious (the gauge + watchdog probe surface
it) but does not tear the gang down.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Sidecar beat cadence. Staleness is judged against
# Config.watchdog_gang_heartbeat_s (default 10s = ~20 missed beats), so
# one chaos-delayed or GC-paused beat never reads as a wedge.
HEARTBEAT_PERIOD_S = 0.5

# Auto-calibrated deadline: k x trailing p99 of observed step time,
# floored so microbenchmark-fast steps don't produce a hair-trigger
# deadline, and armed only after MIN_SAMPLES observations (a cold gang
# has no distribution to calibrate against — no deadline, no trip).
DEADLINE_K = 4.0
DEADLINE_FLOOR_S = 5.0
DEADLINE_MIN_SAMPLES = 3
DEADLINE_WINDOW = 64


class HeartbeatSender:
    """Worker-side sidecar: beats ``gang_heartbeat`` into the GCS.

    Runs on its own daemon thread with its own RpcClient; the send is a
    oneway (fire-and-forget) so a slow GCS never backs the sidecar up.
    Failures are swallowed and retried next beat — a missing heartbeat
    IS the signal the supervisor consumes, never an exception here.
    """

    def __init__(self, gang: str, rank: int,
                 period_s: float = HEARTBEAT_PERIOD_S):
        self.gang = gang
        self.rank = int(rank)
        self.period_s = float(period_s)
        self._step = 0
        self._phase = "init"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._client = None

    # -- main-thread surface (called from the train loop / actor) ------

    def note_step(self, step: Optional[int] = None) -> None:
        self._step = self._step + 1 if step is None else int(step)

    def set_phase(self, phase: str) -> None:
        self._phase = phase

    def start(self) -> bool:
        """Resolve the GCS address from this process's core worker and
        start beating. Returns False (and stays inert) outside a
        connected worker process — heartbeats are best-effort
        observability, never a formation hard-dependency."""
        addr = _gcs_address_or_none()
        if addr is None:
            logger.debug("heartbeat sender for gang %s rank %d: no core "
                         "worker in this process; not starting",
                         self.gang, self.rank)
            return False
        from ray_tpu_torch._private.rpc import RpcClient
        self._client = RpcClient(addr, timeout=5)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"gang-heartbeat-{self.gang}-r{self.rank}")
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001 - teardown; socket may be gone
                pass
            self._client = None

    # -- sidecar thread ------------------------------------------------

    def _run(self) -> None:
        node_id = _node_id_or_empty()
        pid = os.getpid()
        while not self._stop.is_set():
            try:
                self._client.send_oneway(
                    "gang_heartbeat", gang=self.gang, rank=self.rank,
                    step=self._step, phase=self._phase,
                    node_id=node_id, pid=pid)
            except Exception:  # noqa: BLE001 - a missed beat IS the signal
                pass
            self._stop.wait(self.period_s)


def _gcs_address_or_none() -> Optional[Tuple[str, int]]:
    try:
        from ray_tpu_torch._private import worker as worker_mod
        w = worker_mod.global_worker_or_none()
        if w is None or w.core_worker is None:
            return None
        return tuple(w.core_worker.gcs_address)
    except Exception:  # noqa: BLE001 - torn-down worker: stay inert
        return None


def _node_id_or_empty() -> str:
    """This process's node id hex — the GCS node-table key, which is
    what lets gang_heartbeats enrich the record with the NM address
    the hard-kill actuator routes through."""
    try:
        from ray_tpu_torch._private import worker as worker_mod
        w = worker_mod.global_worker_or_none()
        if w is None or w.core_worker is None:
            return ""
        return str(getattr(w.core_worker, "node_id_hex", "") or "")
    except Exception:  # noqa: BLE001 - best-effort enrichment
        return ""


class StepDeadline:
    """Per-step deadline: explicit, or k x trailing-p99 auto-calibrated.

    ``current(override_s)`` resolution order (first non-None wins):
    runtime override (metrics_configure, carried back on every
    heartbeat query) > explicit (ScalingConfig.step_deadline_s) >
    auto-calibration. Auto returns None until MIN_SAMPLES step times
    have been observed — no distribution, no deadline, no trip.
    """

    def __init__(self, explicit_s: Optional[float] = None,
                 k: float = DEADLINE_K,
                 floor_s: float = DEADLINE_FLOOR_S,
                 window: int = DEADLINE_WINDOW,
                 min_samples: int = DEADLINE_MIN_SAMPLES):
        if explicit_s is not None and explicit_s <= 0:
            raise ValueError(f"step deadline must be > 0, got {explicit_s}")
        self.explicit_s = explicit_s
        self.k = float(k)
        self.floor_s = float(floor_s)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self._samples: List[float] = []
        self._lock = threading.Lock()

    def observe(self, step_s: float) -> None:
        if step_s < 0:
            return
        with self._lock:
            self._samples.append(float(step_s))
            if len(self._samples) > self.window:
                del self._samples[:len(self._samples) - self.window]

    def current(self, override_s: Optional[float] = None
                ) -> Optional[float]:
        if override_s is not None and override_s > 0:
            return float(override_s)
        if self.explicit_s is not None:
            return self.explicit_s
        with self._lock:
            if len(self._samples) < self.min_samples:
                return None
            ordered = sorted(self._samples)
        p99 = ordered[min(len(ordered) - 1,
                          int(0.99 * (len(ordered) - 1) + 0.999999))]
        return max(self.floor_s, self.k * p99)


# ---------------------------------------------------------------------------
# Driver-side query / classification / kill helpers
# ---------------------------------------------------------------------------


def query_gang(gcs_call, gang: str) -> Dict[str, Any]:
    """One ``gang_heartbeats`` round trip. Returns the raw reply:
    ``{"ranks": {rank: {step, phase, node_id, pid, nm_address, age_s}},
    "step_deadline_override_s": float|None}``. ``gcs_call`` is any
    callable with the RpcClient.call signature (method, **kwargs)."""
    return gcs_call("gang_heartbeats", gang=gang)


def stale_ranks(reply: Dict[str, Any], stale_after_s: float
                ) -> List[Dict[str, Any]]:
    """Ranks whose heartbeat age exceeds the staleness threshold. Each
    record is the GCS reply row plus its rank under ``"rank"`` and the
    reply's gang under ``"gang"`` (the kill actuator stamps both into
    the NM's kill reason)."""
    out = []
    gang = reply.get("gang", "?")
    for rank, rec in sorted((reply.get("ranks") or {}).items()):
        if rec.get("age_s", 0.0) > stale_after_s:
            out.append({"rank": int(rank), "gang": gang, **rec})
    return out


def classify_wedge(reply: Dict[str, Any],
                   stale: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Slice-aware classification of a wedge.

    Groups ranks by node (an ICI slice maps to a host/node in this
    runtime): when every stale rank sits on a node whose ranks are ALL
    stale, the wedge reads as ``slice_leave`` — one membership event,
    not N independent rank failures. Any stale rank on a node with
    fresh siblings makes it ``rank_wedge``.
    """
    ranks = reply.get("ranks") or {}
    stale_set = {r["rank"] for r in stale}
    by_node: Dict[str, List[int]] = {}
    for rank, rec in ranks.items():
        by_node.setdefault(rec.get("node_id") or "", []).append(int(rank))
    wedged_nodes = [node for node, members in by_node.items()
                    if members and all(m in stale_set for m in members)]
    covered = {m for node in wedged_nodes for m in by_node[node]}
    kind = "slice_leave" if stale_set and stale_set <= covered \
        else "rank_wedge"
    return {"kind": kind, "ranks": sorted(stale_set),
            "nodes": sorted(n for n in wedged_nodes if n)}


def hard_kill_ranks(stale: List[Dict[str, Any]],
                    timeout: float = 10.0) -> List[int]:
    """SIGKILL each wedged rank via its node manager.

    NOT ``ray_tpu_torch.kill``: that path RPCs the victim itself
    (``cw_kill_self``), which a SIGSTOP'd process never answers — the
    kill would block for the full RPC timeout per rank. The NM path
    (``nm_kill_worker_pid``) captures a postmortem bundle (1s budget,
    tolerates an unresponsive victim) then SIGKILLs the pid, which the
    kernel delivers to stopped processes. Returns the ranks confirmed
    killed; misses (rank's NM unreachable, pid already gone) are logged
    and skipped — gang teardown sweeps whatever survives.
    """
    from ray_tpu_torch._private.rpc import RpcClient
    killed: List[int] = []
    for rec in stale:
        nm_addr = rec.get("nm_address")
        pid = rec.get("pid")
        if not nm_addr or not pid:
            logger.warning("wedged rank %s has no NM address/pid on its "
                           "heartbeat record; leaving it to gang teardown",
                           rec.get("rank"))
            continue
        client = RpcClient(tuple(nm_addr), timeout=timeout)
        try:
            if client.call("nm_kill_worker_pid", pid=int(pid),
                           reason=f"gang {rec.get('gang', '?')} rank "
                                  f"{rec['rank']} wedged "
                                  f"(heartbeat {rec.get('age_s', 0):.1f}s "
                                  f"stale)"):
                killed.append(rec["rank"])
        except Exception:  # noqa: BLE001 - NM down: node death path owns it
            logger.warning("nm_kill_worker_pid for wedged rank %s "
                           "(pid %s) failed; its node may be dead",
                           rec["rank"], pid, exc_info=True)
        finally:
            try:
                client.close()
            except Exception:  # noqa: BLE001 - best-effort socket close
                pass
    return killed


def clear_gang(gcs_call, gang: str) -> None:
    """Drop a gang's heartbeat rows (teardown): stale rows from a dead
    formation would otherwise export as wedged-forever gauge series."""
    try:
        gcs_call("gang_heartbeat_clear", gang=gang)
    except Exception:  # noqa: BLE001 - GCS gone at shutdown: rows die with it
        pass
