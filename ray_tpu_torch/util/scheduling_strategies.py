"""Scheduling strategies for tasks/actors.

The port's copy of ray_tpu's ``util/scheduling_strategies.py``, whole.

Role-equivalent of python/ray/util/scheduling_strategies.py
(:: PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


# String strategies "DEFAULT" and "SPREAD" are passed directly as
# scheduling_strategy="SPREAD" (same as the reference).
