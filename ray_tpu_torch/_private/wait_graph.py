"""Runtime wait-graph: actor-level deadlock detection.

An actor whose method blocks in `ray_tpu_torch.get()` on another actor's
pending result registers a `waiter -> target` edge here (hosted by the
GCS). Adding an edge that would close a cycle means every actor on the
path is waiting on the next one with its executor thread held — the
classic nested-get deadlock the static rule RT001 flags at lint time.
Instead of hanging forever, the registering get() raises DeadlockError
carrying the cycle, which unwinds one waiter and lets the rest of the
cycle drain.

reference parity: none — upstream ray hangs on mutual gets; this is the
paper repo's production-readiness addition, surfaced via the dashboard
(`/api/wait_graph`).

Edges are per-actor, not per-thread, so workers only register an edge
when the blocking get holds the last idle executor thread of its
concurrency group (_Executor.has_spare_capacity): an actor with spare
group threads can still field calls from cycle peers and is not a hard
node in the graph. Registration waits out a short grace period first,
so fast gets never involve the GCS at all.

Every edge carries a caller-chosen token, which makes add/remove
idempotent under RPC retry: a retried add that already recorded returns
its original verdict instead of double-counting, and a retried remove
of a gone token is a no-op. A cycle verdict records nothing, so
re-running it on retry is also safe.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple
from ray_tpu_torch.util.locks import TracedLock


class WaitGraph:
    """Directed waits-for graph over actor ids, with cycle-at-insert
    detection. Edges are keyed by token; concurrent gets from one actor
    to the same target stack and unwind independently."""

    def __init__(self) -> None:
        self._lock = TracedLock("wait_graph")
        # waiter hex -> {target hex: outstanding edge count}
        self._edges: Dict[str, Dict[str, int]] = {}
        # token -> (waiter hex, target hex, registered_at monotonic) —
        # the age feeds the metrics watchdog's stuck-wait probe
        self._tokens: Dict[str, Tuple[str, str, float]] = {}
        self.deadlocks_detected = 0

    def add(self, waiter: str, target: str,
            token: str) -> Optional[List[str]]:
        """Register waiter->target under token. Returns None and records
        the edge, or — when the edge would close a cycle — returns the
        cycle path `[waiter, target, ..., waiter]` WITHOUT recording it
        (the caller raises instead of blocking, so the edge never
        materializes)."""
        if waiter == target:
            return [waiter, waiter]
        with self._lock:
            if token in self._tokens:
                return None  # idempotent RPC retry of a recorded add
            path = self._find_path(target, waiter)
            if path is not None:
                self.deadlocks_detected += 1
                return [waiter] + path
            targets = self._edges.setdefault(waiter, {})
            targets[target] = targets.get(target, 0) + 1
            self._tokens[token] = (waiter, target, time.monotonic())
        return None

    def remove(self, token: str) -> None:
        with self._lock:
            edge = self._tokens.pop(token, None)
            if edge is None:
                return  # unknown/already-removed token: idempotent
            self._drop_edge_locked(edge[0], edge[1])

    def _drop_edge_locked(self, waiter: str, target: str) -> None:
        targets = self._edges.get(waiter)
        if not targets:
            return
        n = targets.get(target, 0) - 1
        if n <= 0:
            targets.pop(target, None)
            if not targets:
                self._edges.pop(waiter, None)
        else:
            targets[target] = n

    def drop_actor(self, actor: str) -> None:
        """Forget a dead actor: its outgoing edges (its gets died with
        it) and edges pointing at it (waiters get ActorDiedError)."""
        with self._lock:
            self._edges.pop(actor, None)
            for targets in self._edges.values():
                targets.pop(actor, None)
            self._tokens = {tok: rec
                            for tok, rec in self._tokens.items()
                            if rec[0] != actor and rec[1] != actor}

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src -> dst following edges; None if unreachable.
        Called under self._lock."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, {}):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            now = time.monotonic()
            oldest: Dict[Tuple[str, str], float] = {}
            for w, t, t0 in self._tokens.values():
                age = now - t0
                if age > oldest.get((w, t), -1.0):
                    oldest[(w, t)] = age
            edges = [{"waiter": w, "target": t, "count": c,
                      "age_s": oldest.get((w, t), 0.0)}
                     for w, targets in self._edges.items()
                     for t, c in targets.items()]
            return {"edges": edges,
                    "max_edge_age_s": max(oldest.values(), default=0.0),
                    "deadlocks_detected": self.deadlocks_detected}


def format_cycle(cycle: List[str],
                 class_names: Optional[Dict[str, str]] = None) -> str:
    """Human-readable cycle: `Learner(a1b2c3) -> Runner(d4e5f6) -> ...`."""
    names = class_names or {}
    parts = []
    for hex_id in cycle:
        cls = names.get(hex_id)
        short = hex_id[:12]
        parts.append(f"{cls}({short})" if cls else short)
    return " -> ".join(parts)
