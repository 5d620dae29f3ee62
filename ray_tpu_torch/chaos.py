"""Public chaos-engineering API: deterministic, targeted fault injection.

The cluster holds a GCS-hosted ChaosPolicy — an ordered list of rules,
each fault x selector x trigger — distributed to every process and
consulted at cheap hook points in the RPC layer, the object store, and
the node manager (see _private/chaos.py for the full semantics).

    import ray_tpu_torch
    from ray_tpu_torch import chaos

    # one-shot: drop the 3rd store pull, then never again
    rid = chaos.inject("drop_connection", method="store_pull",
                      after_n=2, max_fires=1)

    # seeded probabilistic delays on every GCS actor RPC
    chaos.inject("delay", method="report_actor_*", delay_ms=5,
                 jitter=True, probability=0.3, seed=42)

    # kill the TrainWorker actor's process on its 4th task push
    chaos.inject("kill_worker", actor_class="RayTrainWorker", after_n=3,
                 max_fires=1)

    chaos.list_rules()   # rules + cluster-wide fired counts
    chaos.clear()        # remove every rule

Every fire increments the per-process prometheus counter
`ray_tpu_chaos_faults_injected_total{fault,rule_id}` and emits a
`CHAOS_FAULT_INJECTED` cluster event, so chaos runs are auditable via
`ray_tpu chaos list`, the dashboard `/api/chaos` endpoint, and
`ray_tpu_torch.util.state.list_cluster_events()`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.chaos import FAULT_TYPES  # noqa: F401 (re-export)

__all__ = ["FAULT_TYPES", "inject", "inject_many", "clear", "list_rules"]


def _gcs():
    from ray_tpu_torch._private import worker as worker_mod
    return worker_mod.global_worker().core_worker._gcs


def inject(fault: str, *,
           method: Optional[str] = None,
           node_id: str = "",
           nodes: Tuple[str, str] = ("", ""),
           actor_class: str = "",
           object_glob: str = "",
           probability: float = 1.0,
           seed: int = 0,
           after_n: int = 0,
           max_fires: int = -1,
           delay_ms: float = 0.0,
           jitter: bool = False,
           error_message: str = "",
           rule_id: str = "") -> str:
    """Install one chaos rule cluster-wide; returns its rule id.

    fault: one of `delay` (RPC server dispatch), `drop_connection` /
    `partition` (RPC client call), `kill_worker` (worker process
    suicide / node-manager kill), `stall_worker` (node manager SIGSTOPs
    a matching worker for `delay_ms` milliseconds, then SIGCONTs it —
    the hung-collective fault: every thread freezes, heartbeat sidecars
    included; delay_ms=0 stalls until something kills the process),
    `error` / `evict_object` (store create/get/pull).

    Selectors: `method` (glob over RPC method or store op name; for
    kill_worker it defaults to "w_push_task" so counters track task
    pushes, for stall_worker to "nm_*" so rules fire on node-manager
    dispatch — the NM serves harvest RPCs every couple of seconds),
    `node_id` (hex prefix), `nodes` (partition pair of hex prefixes),
    `actor_class` (glob), `object_glob` (object id glob).

    Trigger: the first `after_n` matching calls pass through; then each
    match fires with `probability` drawn from a seeded per-process RNG,
    up to `max_fires` times (1 = one-shot, enforced cluster-wide via the
    GCS fired-count aggregate; -1 = unlimited).
    """
    if fault not in FAULT_TYPES:
        raise ValueError(f"unknown fault {fault!r} (one of {FAULT_TYPES})")
    if method is None:
        method = {"kill_worker": "w_push_task",
                  "stall_worker": "nm_*"}.get(fault, "*")
    rule = {
        "fault": fault, "rule_id": rule_id, "method": method,
        "node_id": node_id, "nodes": tuple(nodes),
        "actor_class": actor_class, "object_glob": object_glob,
        "probability": probability, "seed": seed, "after_n": after_n,
        "max_fires": max_fires, "delay_ms": delay_ms, "jitter": jitter,
        "error_message": error_message,
    }
    return _gcs().call("chaos_inject", rules=[rule])[0]


def inject_many(rules: List[Dict[str, Any]]) -> List[str]:
    """Install an ordered schedule of rules atomically (one policy
    version bump); each dict takes the same keys as inject()."""
    return _gcs().call("chaos_inject", rules=list(rules))


def clear(rule_ids: Optional[List[str]] = None) -> int:
    """Remove rules (all of them when rule_ids is None); returns how
    many were removed. Clearing also resets the policy every process
    holds."""
    return _gcs().call("chaos_clear", rule_ids=rule_ids)


def list_rules() -> List[Dict[str, Any]]:
    """Installed rules, each with its cluster-wide `fired` count."""
    return _gcs().call("chaos_list")["rules"]
