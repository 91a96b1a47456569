"""Logical plan: declarative ops + fusion into physical stages.

Copy of ray_tpu's ``data/_internal/plan.py``: Dataset methods append
LogicalOps; the planner fuses maximal runs of row/batch-wise ops into single
task functions (operator fusion: one task applies the whole fused chain per
block), and all-to-all ops (shuffle/sort/groupby/repartition) become
barrier stages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class LogicalOp:
    name: str = "op"


@dataclass
class Read(LogicalOp):
    """Leaf: a datasource's read tasks (each returns an iterator of blocks)."""

    read_tasks: list = field(default_factory=list)  # list[Callable[[], Iterator[Block]]]
    name: str = "Read"


@dataclass
class InputData(LogicalOp):
    """Leaf: pre-materialized blocks (from_items / from_numpy / from_arrow)."""

    blocks: list = field(default_factory=list)  # list[ObjectRef | Block]
    name: str = "InputData"


@dataclass
class MapBatches(LogicalOp):
    fn: Any = None  # callable or actor class
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    compute: str = "tasks"  # "tasks" | "actors"
    fn_args: tuple = ()
    fn_kwargs: dict = field(default_factory=dict)
    fn_constructor_args: tuple = ()
    num_cpus: float = 1.0
    name: str = "MapBatches"


@dataclass
class MapRows(LogicalOp):
    fn: Callable = None
    name: str = "Map"


@dataclass
class FlatMap(LogicalOp):
    fn: Callable = None
    name: str = "FlatMap"


@dataclass
class Filter(LogicalOp):
    fn: Callable = None
    name: str = "Filter"


@dataclass
class Limit(LogicalOp):
    limit: int = 0
    name: str = "Limit"


@dataclass
class Repartition(LogicalOp):
    num_blocks: int = 1
    name: str = "Repartition"


@dataclass
class RandomShuffle(LogicalOp):
    seed: Optional[int] = None
    name: str = "RandomShuffle"


@dataclass
class Sort(LogicalOp):
    key: str = ""
    descending: bool = False
    name: str = "Sort"


@dataclass
class Aggregate(LogicalOp):
    key: Optional[str] = None
    aggs: list = field(default_factory=list)  # list[AggregateFn]
    name: str = "Aggregate"


@dataclass
class Zip(LogicalOp):
    other: "LogicalPlan" = None
    name: str = "Zip"


@dataclass
class Union(LogicalOp):
    others: list = field(default_factory=list)  # list[LogicalPlan]
    name: str = "Union"


class LogicalPlan:
    def __init__(self, ops: list[LogicalOp]):
        self.ops = ops

    def with_op(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def describe(self) -> str:
        return " -> ".join(op.name for op in self.ops)


# ---- planner: fuse map-like runs into stages ----

_MAPLIKE = (MapBatches, MapRows, FlatMap, Filter)


@dataclass
class MapStage:
    """A fused run of map-like ops executed as ONE task per input block."""

    ops: list[LogicalOp]
    compute: str = "tasks"
    fn_actor_cls: Any = None  # set when any MapBatches uses actor compute
    name: str = "MapStage"

    def describe(self) -> str:
        return "+".join(op.name for op in self.ops)


@dataclass
class AllToAllStage:
    op: LogicalOp
    name: str = "AllToAll"

    def describe(self) -> str:
        return self.op.name


@dataclass
class SourceStage:
    op: LogicalOp  # Read | InputData

    def describe(self) -> str:
        return self.op.name


def plan_stages(plan: LogicalPlan) -> list:
    """Linear planner: source stage, then alternating fused-map / barrier
    stages in op order."""
    if not plan.ops:
        return []
    stages: list = [SourceStage(plan.ops[0])]
    run: list[LogicalOp] = []

    def flush():
        nonlocal run
        if run:
            compute = "tasks"
            for op in run:
                if isinstance(op, MapBatches) and op.compute == "actors":
                    compute = "actors"
            stages.append(MapStage(run, compute=compute))
            run = []

    for op in plan.ops[1:]:
        if isinstance(op, _MAPLIKE):
            run.append(op)
        else:
            flush()
            stages.append(AllToAllStage(op))
    flush()
    return stages
