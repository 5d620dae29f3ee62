"""Placement groups: gang reservation of resource bundles.

reference parity: python/ray/util/placement_group.py:41,146,257,312 —
`PlacementGroup` handle, `placement_group()` factory, `remove_placement_group`,
`get_current_placement_group`; strategies PACK/SPREAD/STRICT_PACK/
STRICT_SPREAD scheduled by the GCS with 2-phase prepare/commit across node
managers (reference gcs_placement_group_scheduler.h:274).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


def _core():
    from ray_tpu_torch._private.worker import global_worker
    return global_worker().core_worker


@dataclass
class PlacementGroup:
    """Handle to a placement group (reference placement_group.py:41)."""

    id: PlacementGroupID
    bundle_specs: List[Dict[str, float]] = field(default_factory=list)

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def _info(self):
        return _core()._gcs.call(
            "get_placement_group", pg_id_hex=self.id.hex())

    def ready(self):
        """ObjectRef that resolves when the group is committed — schedules
        a trivial task inside bundle 0 (reference placement_group.py:90:
        ready() is implemented as a 0-CPU task in the group)."""
        import ray_tpu_torch
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy)

        @ray_tpu_torch.remote
        def _pg_ready():
            return True

        return _pg_ready.options(
            num_cpus=0,
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=self,
                placement_group_bundle_index=0)).remote()

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block until CREATED (or timeout). reference
        placement_group.py:111."""
        deadline = time.monotonic() + timeout_seconds
        while time.monotonic() < deadline:
            info = self._info()
            if info is not None and info.state == "CREATED":
                return True
            if info is not None and info.state in ("REMOVED", "INFEASIBLE"):
                return False
            time.sleep(0.05)
        return False

    def is_ready(self) -> bool:
        info = self._info()
        return info is not None and info.state == "CREATED"


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    """Create a placement group asynchronously (reference
    placement_group.py:146)."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b!r}")

    cw = _core()
    pg_id = PlacementGroupID.from_random()
    cw._gcs.call(
        "create_placement_group", pg_id_hex=pg_id.hex(),
        bundles=[dict(b) for b in bundles], strategy=strategy, name=name,
        detached=(lifetime == "detached"),
        creator_job_id=cw.job_id.hex())
    return PlacementGroup(id=pg_id, bundle_specs=[dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup) -> None:
    """reference placement_group.py:257."""
    _core()._gcs.call("remove_placement_group", pg_id_hex=pg.id.hex())


def placement_group_table() -> Dict[str, Dict]:
    """All placement groups (reference placement_group.py:285)."""
    infos = _core()._gcs.call("list_placement_groups")
    return {
        info.pg_id.hex(): {
            "placement_group_id": info.pg_id.hex(),
            "name": info.name,
            "bundles": {i: b for i, b in enumerate(info.bundles)},
            "strategy": info.strategy,
            "state": info.state,
            "bundle_nodes": list(info.bundle_nodes),
        }
        for info in infos
    }


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The placement group of the current task/actor, if it was scheduled
    into one (reference placement_group.py:312)."""
    cw = _core()
    pg_id = getattr(cw, "current_placement_group_id", None)
    if pg_id is None:
        return None
    info = cw._gcs.call("get_placement_group", pg_id_hex=pg_id.hex())
    if info is None:
        return None
    return PlacementGroup(id=pg_id, bundle_specs=list(info.bundles))
