"""Scheduling strategies (reference: python/ray/util/scheduling_strategies.py
:15,41,135 — PlacementGroupSchedulingStrategy / NodeAffinitySchedulingStrategy
/ NodeLabelSchedulingStrategy). The dataclasses live in
ray_tpu_torch._private.state so the scheduler can depend on them without a cycle;
this module is the public import path."""

from ray_tpu_torch._private.state import (  # noqa: F401
    DefaultSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SchedulingStrategy,
    SpreadSchedulingStrategy,
)

__all__ = [
    "SchedulingStrategy", "DefaultSchedulingStrategy",
    "SpreadSchedulingStrategy", "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy", "NodeLabelSchedulingStrategy",
]
