"""Cluster scheduling policies.

reference parity: src/ray/raylet/scheduling/policy/ — hybrid (pack with
spill-over past a utilization threshold, hybrid_scheduling_policy.cc), spread
(spread_scheduling_policy.cc), node-affinity
(node_affinity_scheduling_policy.h) and placement-group bundle placement
(bundle_scheduling_policy.cc). Operates on a {node_id: {resource: available}}
view synced through the GCS (reference syncs via RaySyncer).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ray_tpu_torch._private.state import (DefaultSchedulingStrategy,
                                    NodeAffinitySchedulingStrategy,
                                    NodeLabelSchedulingStrategy,
                                    PlacementGroupSchedulingStrategy,
                                    ResourceSet, SchedulingStrategy,
                                    SpreadSchedulingStrategy)

# reference ray_config_def.h: scheduler_spread_threshold (0.5): prefer the
# local/first node until its utilization crosses this, then best-fit spill.
SPREAD_THRESHOLD = 0.5


def _feasible(avail: Dict[str, float], required: ResourceSet) -> bool:
    return required.is_subset_of(ResourceSet(avail))


def _utilization(total: ResourceSet, avail: Dict[str, float]) -> float:
    util = 0.0
    for k, tot in total.to_dict().items():
        if tot > 0:
            util = max(util, 1.0 - min(ResourceSet(avail).get(k) / tot, 1.0))
    return util


def _labels_match(node_labels: Dict[str, str],
                  constraints: Dict[str, List[str]]) -> bool:
    for key, allowed in constraints.items():
        if key not in node_labels:
            return False
        if allowed and "" not in allowed and \
                node_labels[key] not in allowed:
            return False
    return True


def pick_node(view: Dict[str, Dict[str, float]], required: ResourceSet,
              strategy: SchedulingStrategy,
              local_node_id: Optional[str] = None,
              totals: Optional[Dict[str, Dict[str, float]]] = None,
              rng: Optional[random.Random] = None,
              locality_hints: Optional[Dict[str, float]] = None,
              labels: Optional[Dict[str, Dict[str, str]]] = None
              ) -> Optional[str]:
    """Return the chosen node id hex, or None if nothing feasible now."""
    feasible = [nid for nid, avail in view.items() if _feasible(avail, required)]
    if not feasible:
        return None
    feasible.sort()  # determinism

    if isinstance(strategy, NodeLabelSchedulingStrategy):
        # reference node_label_scheduling_policy.h: hard constraints
        # filter; soft constraints prefer.
        labels = labels or {}
        hard_ok = [n for n in feasible
                   if _labels_match(labels.get(n, {}), strategy.hard)]
        if not hard_ok:
            return None
        soft_ok = [n for n in hard_ok
                   if _labels_match(labels.get(n, {}), strategy.soft)]
        return (soft_ok or hard_ok)[0]

    # Object locality (reference lease_policy.h:56 LocalityAwareLeasePolicy
    # + scorer.h): among feasible nodes, prefer the one already holding
    # the most argument bytes — object-heavy pipelines (RL trajectories)
    # then read args from local shm instead of pulling across nodes.
    if locality_hints and isinstance(strategy, DefaultSchedulingStrategy):
        best = max(feasible, key=lambda n: locality_hints.get(n, 0.0))
        if locality_hints.get(best, 0.0) > 0.0:
            return best

    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        if strategy.node_id in view and _feasible(view[strategy.node_id],
                                                  required):
            return strategy.node_id
        return feasible[0] if strategy.soft else None

    if isinstance(strategy, SpreadSchedulingStrategy):
        # round-robin-ish: least utilized first (reference spreads over
        # top-k least loaded)
        if totals:
            feasible.sort(key=lambda nid: _utilization(
                ResourceSet(totals.get(nid, view[nid])), view[nid]))
        else:
            (rng or random).shuffle(feasible)
        return feasible[0]

    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        # Bundle-constrained placement resolved by the caller (bundle
        # resources appear as custom resources on the reserving node).
        return feasible[0]

    # Default/hybrid: prefer local while under the spread threshold, else
    # pick the best (most packed but feasible) node — reference
    # hybrid_scheduling_policy.cc.
    if local_node_id in feasible and totals is not None:
        local_util = _utilization(
            ResourceSet(totals.get(local_node_id, {})), view[local_node_id])
        if local_util < SPREAD_THRESHOLD:
            return local_node_id
    elif local_node_id in feasible:
        return local_node_id
    if totals:
        feasible.sort(key=lambda nid: (-_utilization(
            ResourceSet(totals.get(nid, view[nid])), view[nid]), nid))
        for nid in feasible:
            if _utilization(ResourceSet(totals.get(nid, view[nid])),
                            view[nid]) < 1.0 - 1e-9:
                return nid
    return feasible[0]


def pack_bundles(view: Dict[str, Dict[str, float]],
                 bundles: List[Dict[str, float]],
                 strategy: str) -> Optional[List[str]]:
    """Assign each bundle to a node; returns node id per bundle or None.

    reference parity: bundle_scheduling_policy.cc — PACK tries to co-locate,
    SPREAD distributes, STRICT_PACK requires one node, STRICT_SPREAD requires
    distinct nodes.
    """
    work = {nid: dict(avail) for nid, avail in view.items()}
    nids = sorted(work)

    def fits(nid: str, bundle: Dict[str, float]) -> bool:
        return ResourceSet(bundle).is_subset_of(ResourceSet(work[nid]))

    def take(nid: str, bundle: Dict[str, float]) -> None:
        avail = ResourceSet(work[nid])
        avail.subtract(ResourceSet(bundle))
        work[nid] = avail.to_dict()

    placement: List[Optional[str]] = [None] * len(bundles)

    if strategy == "STRICT_PACK":
        for nid in nids:
            if all(ResourceSet(_sum_bundles(bundles)).is_subset_of(
                    ResourceSet(work[nid])) for _ in (0,)):
                return [nid] * len(bundles)
        return None

    if strategy == "STRICT_SPREAD":
        if len(bundles) > len(nids):
            return None
        used: set = set()
        for i, b in enumerate(bundles):
            cand = [n for n in nids if n not in used and fits(n, b)]
            if not cand:
                return None
            placement[i] = cand[0]
            used.add(cand[0])
            take(cand[0], b)
        return placement  # type: ignore[return-value]

    # PACK / SPREAD: best effort
    order = nids if strategy == "PACK" else list(nids)
    for i, b in enumerate(bundles):
        if strategy == "SPREAD":
            order = sorted(nids, key=lambda n: -sum(work[n].values()))
        chosen = next((n for n in order if fits(n, b)), None)
        if chosen is None:
            return None
        placement[i] = chosen
        take(chosen, b)
    return placement  # type: ignore[return-value]


def _sum_bundles(bundles: List[Dict[str, float]]) -> Dict[str, float]:
    total = ResourceSet({})
    for b in bundles:
        total.add(ResourceSet(b))
    return total.to_dict()
