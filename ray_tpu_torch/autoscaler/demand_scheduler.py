"""Resource-demand bin-packing for the autoscaler.

reference parity: autoscaler/_private/resource_demand_scheduler.py —
given (a) the pending resource demands the cluster cannot place (queued
lease shapes + pending placement-group bundles) and (b) a catalog of
launchable node types, compute how many nodes of each type to launch:
first bin-pack demands onto the EXISTING nodes' available capacity
(they may just be busy momentarily), then first-fit-decreasing pack the
remainder onto virtual nodes drawn from the type catalog, preferring
the smallest type that fits each seed demand.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class NodeType:
    """One launchable shape (reference: available_node_types entries)."""

    name: str
    resources: Dict[str, float]
    max_workers: int = 100


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v - 1e-9 for k, v in demand.items()
               if v > 0)


def _consume(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        if v > 0:
            avail[k] = avail.get(k, 0.0) - v


def _demand_size(d: Dict[str, float]) -> Tuple[float, float]:
    # sort key: GPU/TPU-ish custom resources first, then CPU volume
    special = sum(v for k, v in d.items() if k not in ("CPU", "memory"))
    return (special, sum(d.values()))


def get_nodes_to_launch(
        pending_demands: List[Dict[str, float]],
        existing_available: List[Dict[str, float]],
        node_types: List[NodeType],
        *,
        existing_count_by_type: Optional[Dict[str, int]] = None,
        max_total_nodes: Optional[int] = None,
) -> Tuple[Dict[str, int], List[Dict[str, float]]]:
    """Return ({node_type_name: count_to_launch}, unplaceable_demands).

    First-fit-decreasing over existing capacity, then over virtual
    nodes opened from the catalog (smallest adequate type first), the
    reference scheduler's core loop
    (resource_demand_scheduler.py get_nodes_to_launch).
    """
    counts = dict(existing_count_by_type or {})
    total_existing = len(existing_available)
    avail = [dict(a) for a in existing_available]
    virtual: List[Tuple[str, Dict[str, float]]] = []
    to_launch: Dict[str, int] = {}
    unplaceable: List[Dict[str, float]] = []

    # catalog sorted smallest-first so each seed demand opens the
    # tightest-fitting node (avoids giant nodes for 1-CPU tasks)
    catalog = sorted(node_types, key=lambda t: _demand_size(t.resources))

    for demand in sorted(pending_demands, key=_demand_size, reverse=True):
        placed = False
        for a in avail:
            if _fits(a, demand):
                _consume(a, demand)
                placed = True
                break
        if placed:
            continue
        for _, a in virtual:
            if _fits(a, demand):
                _consume(a, demand)
                placed = True
                break
        if placed:
            continue
        launched = sum(to_launch.values())
        if max_total_nodes is not None and \
                total_existing + launched >= max_total_nodes:
            unplaceable.append(demand)
            continue
        for t in catalog:
            if not _fits(dict(t.resources), demand):
                continue
            if counts.get(t.name, 0) + to_launch.get(t.name, 0) \
                    >= t.max_workers:
                continue
            a = dict(t.resources)
            _consume(a, demand)
            virtual.append((t.name, a))
            to_launch[t.name] = to_launch.get(t.name, 0) + 1
            placed = True
            break
        if not placed:
            unplaceable.append(demand)
    return to_launch, unplaceable


@dataclass
class PlacementGroupDemand:
    """Pending PG bundles feed the same packer; STRICT_SPREAD bundles
    must land on distinct nodes, so they are emitted as per-bundle
    demands tagged anti-affine (reference: the scheduler's
    placement-group resource demand expansion)."""

    bundles: List[Dict[str, float]] = field(default_factory=list)
    strategy: str = "PACK"

    def expand(self) -> List[Dict[str, float]]:
        if self.strategy in ("STRICT_PACK",):
            # one node must fit the whole group: merge bundles
            merged: Dict[str, float] = {}
            for b in self.bundles:
                for k, v in b.items():
                    merged[k] = merged.get(k, 0.0) + v
            return [merged]
        return [dict(b) for b in self.bundles]
