"""Streaming executor: drives the physical stage pipeline.

Port of ray_tpu's ``data/_internal/streaming_executor.py``: blocks stream
through fused map stages with a bounded in-flight task window
(backpressure), materializing only at all-to-all barriers. Map stages run
as tasks of the local pool (stateless UDFs) or on an autoscaling pool of
actors (stateful, class UDFs), both from ``_private.local_tasks``. The
window's byte budget reads that store's used bytes against its capacity.

The reference defines ``_zip``'s tasks inside the method; here they are
module-level functions, which the workers import by name. The behaviour
is the same.
"""

from __future__ import annotations

import time
from typing import Any, Iterator

from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.data.block import BlockAccessor, DataContext, concat, num_rows
from ray_tpu_torch.data._internal.map_fn import instantiate_udfs, make_fused_fn
from ray_tpu_torch.data._internal.plan import (
    Aggregate,
    AllToAllStage,
    InputData,
    Limit,
    MapStage,
    RandomShuffle,
    Read,
    Repartition,
    Sort,
    SourceStage,
    Union,
    Zip,
)
from ray_tpu_torch.data._internal.shuffle import (
    groupby_aggregate,
    sample_sort_bounds,
    shuffle_blocks,
)


def _task_meta(block, cpu0: float) -> dict:
    accessor = BlockAccessor.for_block(block)
    return {"rows": accessor.num_rows(), "bytes": accessor.size_bytes(),
            "cpu_s": time.thread_time() - cpu0}


@local_tasks.remote(num_returns=2)
def _run_read_task(read_task) -> Any:
    cpu0 = time.thread_time()
    out = concat(list(read_task()))
    return out, _task_meta(out, cpu0)


@local_tasks.remote(num_returns=2)
def _map_task(ops: list, block) -> Any:
    cpu0 = time.thread_time()
    out = make_fused_fn(ops)(block)
    return out, _task_meta(out, cpu0)


@local_tasks.remote
def _num_rows(block) -> int:
    return BlockAccessor.for_block(block).num_rows()


@local_tasks.remote
def _slice_block(block, start: int, end: int):
    return BlockAccessor.for_block(block).slice(start, end)


@local_tasks.remote
class _MapActor:
    """Actor-pool worker: constructs stateful UDFs once, maps blocks.
    Accumulates its own execution stats (collected once at stage end)."""

    def __init__(self, ops: list):
        self._ops = ops
        self._fused = make_fused_fn(ops, instantiate_udfs(ops))
        self._rows = 0
        self._bytes = 0
        self._cpu_s = 0.0
        self._tasks = 0

    def map(self, block) -> Any:
        cpu0 = time.thread_time()
        out = self._fused(block)
        accessor = BlockAccessor.for_block(out)
        self._rows += accessor.num_rows()
        self._bytes += accessor.size_bytes()
        self._cpu_s += time.thread_time() - cpu0
        self._tasks += 1
        return out

    def get_exec_stats(self) -> dict:
        return {
            "rows": self._rows, "bytes": self._bytes,
            "cpu_s": self._cpu_s, "tasks": self._tasks,
        }


@local_tasks.remote
def _concat_all(*blocks):
    return concat(list(blocks))


@local_tasks.remote
def _zip_blocks(left, right):
    lt = BlockAccessor.for_block(left).block
    rt = BlockAccessor.for_block(right).block
    if num_rows(lt) != num_rows(rt):
        raise ValueError(f"zip row-count mismatch: {num_rows(lt)} vs {num_rows(rt)}")
    cols = dict(lt)
    for name, col in rt.items():
        out_name = name
        while out_name in cols:
            out_name = out_name + "_1"
        cols[out_name] = col
    return cols


def _collect_metas(stats: "_StageStats", meta_refs: list) -> None:
    """Fold completed per-task metadata into stage stats; one bounded wait
    in all: tasks whose meta is not ready (an early-stopped stream) are
    skipped, not waited for."""
    if not meta_refs:
        return
    try:
        ready, _ = local_tasks.wait(meta_refs, num_returns=len(meta_refs), timeout=1.0)
        for ref in ready:
            stats.add_meta(local_tasks.get(ref))
    except local_tasks.TaskError:  # stats are advisory; a failed task raised at its block
        pass


class _StageStats:
    def __init__(self, name: str):
        self.name = name
        self.wall_s = 0.0
        self.blocks_out = 0
        self.rows_out = 0
        self.bytes_out = 0
        self.cpu_s = 0.0
        self.tasks = 0

    def add_meta(self, meta: dict) -> None:
        self.rows_out += meta.get("rows", 0)
        self.bytes_out += meta.get("bytes", 0)
        self.cpu_s += meta.get("cpu_s", 0.0)
        self.tasks += meta.get("tasks", 1)


class StreamingExecutor:
    def __init__(self, stages: list, ctx: DataContext | None = None):
        self.stages = stages
        self.ctx = ctx or DataContext.get_current()
        self.stage_stats: list[_StageStats] = []
        self._throttled = 0  # byte-budget admission rejections (stats)
        self._budget_checked_at = 0.0
        self._budget_over = False

    # -- public --

    def execute(self) -> Iterator:
        """Yield output block refs as they become available."""
        stream: Iterator = iter(())
        for stage in self.stages:
            stats = _StageStats(stage.describe())
            self.stage_stats.append(stats)
            if isinstance(stage, SourceStage):
                stream = self._run_source(stage, stats)
            elif isinstance(stage, MapStage):
                stream = self._run_map(stage, stream, stats)
            elif isinstance(stage, AllToAllStage):
                stream = self._run_all_to_all(stage, stream, stats)
            else:
                raise TypeError(stage)
        return stream

    def execute_to_refs(self) -> list:
        return list(self.execute())

    # -- backpressure ----------------------------------------------------
    def _admit(self, n_pending: int, window: int) -> bool:
        """Admission control = task window AND object-store byte budget:
        beyond the first in-flight task, launching stops while the local
        store holds more than ``streaming_store_budget_fraction`` of its
        capacity."""
        if n_pending >= window:
            return False
        if n_pending == 0:
            return True  # progress guarantee
        frac = getattr(self.ctx, "streaming_store_budget_fraction", 1.0)
        if frac >= 1.0:
            return True
        now = time.monotonic()
        if now - self._budget_checked_at > 0.05:
            self._budget_checked_at = now
            stats = local_tasks.store_stats()
            self._budget_over = stats["used"] > frac * stats["capacity"]
        if self._budget_over:
            self._throttled += 1
        return not self._budget_over

    # -- stages --

    def _run_source(self, stage: SourceStage, stats: _StageStats) -> Iterator:
        op = stage.op
        start = time.perf_counter()
        if isinstance(op, InputData):
            for block in op.blocks:
                stats.blocks_out += 1
                yield block if _is_ref(block) else local_tasks.put(
                    BlockAccessor.for_block(block).block
                )
            stats.wall_s += time.perf_counter() - start
            return
        if not isinstance(op, Read):
            raise TypeError(op)
        window = self.ctx.streaming_max_inflight_tasks
        pending: list = []
        meta_refs: list = []
        tasks = list(op.read_tasks)
        idx = 0
        try:
            while idx < len(tasks) or pending:
                while idx < len(tasks) and self._admit(len(pending), window):
                    block_ref, meta_ref = _run_read_task.remote(tasks[idx])
                    meta_refs.append(meta_ref)
                    pending.append(block_ref)
                    idx += 1
                ready, pending_rest = local_tasks.wait(pending, num_returns=1)
                pending = list(pending_rest)
                for ref in ready:
                    stats.blocks_out += 1
                    stats.wall_s += time.perf_counter() - start
                    yield ref
                    start = time.perf_counter()
        finally:
            # Batched: one read at stream end, never in the per-block loop.
            _collect_metas(stats, meta_refs)

    def _run_map(
        self, stage: MapStage, stream: Iterator, stats: _StageStats
    ) -> Iterator:
        if stage.compute == "actors":
            yield from self._run_map_actors(stage, stream, stats)
            return
        window = self.ctx.streaming_max_inflight_tasks
        pending: list = []
        meta_refs: list = []
        start = time.perf_counter()
        exhausted = False
        try:
            while not exhausted or pending:
                while not exhausted and self._admit(len(pending), window):
                    try:
                        block_ref = next(stream)
                    except StopIteration:
                        exhausted = True
                        break
                    out_ref, meta_ref = _map_task.remote(stage.ops, block_ref)
                    meta_refs.append(meta_ref)
                    pending.append(out_ref)
                if not pending:
                    break
                ready, pending_rest = local_tasks.wait(pending, num_returns=1)
                pending = list(pending_rest)
                for ref in ready:
                    stats.blocks_out += 1
                    stats.wall_s += time.perf_counter() - start
                    yield ref
                    start = time.perf_counter()
        finally:
            _collect_metas(stats, meta_refs)

    def _run_map_actors(
        self, stage: MapStage, stream: Iterator, stats: _StageStats
    ) -> Iterator:
        pool_size = self.ctx.actor_pool_min_size
        actors = [_MapActor.remote(stage.ops) for _ in range(pool_size)]
        per_actor_inflight = 2
        pending: dict[Any, int] = {}  # ref -> actor idx
        load = [0] * len(actors)
        start = time.perf_counter()
        exhausted = False
        completed = False
        try:
            while not exhausted or pending:
                while (
                    not exhausted
                    and min(load) < per_actor_inflight
                    and self._admit(len(pending), len(actors) * per_actor_inflight)
                ):
                    # autoscale up to max while all actors are busy
                    if (
                        all(n > 0 for n in load)
                        and len(actors) < self.ctx.actor_pool_max_size
                    ):
                        actors.append(_MapActor.remote(stage.ops))
                        load.append(0)
                    try:
                        block_ref = next(stream)
                    except StopIteration:
                        exhausted = True
                        break
                    target = load.index(min(load))
                    ref = actors[target].map.remote(block_ref)
                    pending[ref] = target
                    load[target] += 1
                if not pending:
                    break
                ready, _ = local_tasks.wait(list(pending), num_returns=1)
                for ref in ready:
                    load[pending.pop(ref)] -= 1
                    stats.blocks_out += 1
                    stats.wall_s += time.perf_counter() - start
                    yield ref
                    start = time.perf_counter()
            completed = True
        finally:
            for actor in actors:
                if completed:
                    # Only on normal exhaustion: an early-stopped stream
                    # (a downstream limit) must not wait on busy actors.
                    try:
                        stats.add_meta(
                            local_tasks.get(actor.get_exec_stats.remote(), timeout=10)
                        )
                    except (local_tasks.TaskError, TimeoutError):
                        pass  # advisory stats from an actor that failed or is busy
                local_tasks.kill(actor)

    def _run_all_to_all(
        self, stage: AllToAllStage, stream: Iterator, stats: _StageStats
    ) -> Iterator:
        op = stage.op
        start = time.perf_counter()

        if isinstance(op, Limit):
            taken = 0
            for ref in stream:
                if taken >= op.limit:
                    break
                rows = local_tasks.get(_num_rows.remote(ref))
                if taken + rows <= op.limit:
                    taken += rows
                    stats.blocks_out += 1
                    yield ref
                else:
                    keep = op.limit - taken
                    taken = op.limit
                    stats.blocks_out += 1
                    yield _slice_block.remote(ref, 0, keep)
            stats.wall_s += time.perf_counter() - start
            return

        if isinstance(op, Union):
            for ref in stream:
                stats.blocks_out += 1
                yield ref
            for other_refs in op.others:
                for ref in other_refs:
                    stats.blocks_out += 1
                    yield ref
            stats.wall_s += time.perf_counter() - start
            return

        refs = list(stream)

        if isinstance(op, Repartition):
            out = shuffle_blocks(refs, op.num_blocks, "slice")
        elif isinstance(op, RandomShuffle):
            out = shuffle_blocks(
                refs, max(1, len(refs)), "random",
                seed=op.seed if op.seed is not None else int(time.time()),
            )
        elif isinstance(op, Sort):
            bounds = sample_sort_bounds(refs, op.key, max(1, len(refs)))
            out = shuffle_blocks(
                refs,
                max(1, len(refs)),
                "range",
                key={"key": op.key, "bounds": bounds, "descending": op.descending},
            )
        elif isinstance(op, Aggregate):
            out = groupby_aggregate(refs, op.key, op.aggs, max(1, len(refs)))
        elif isinstance(op, Zip):
            out = self._zip(refs, list(op.other))
        else:
            raise TypeError(op)
        for ref in out:
            stats.blocks_out += 1
            yield ref
        stats.wall_s += time.perf_counter() - start

    @staticmethod
    def _zip(left_refs: list, right_refs: list) -> list:
        left = _concat_all.remote(*left_refs) if len(left_refs) != 1 else left_refs[0]
        right = _concat_all.remote(*right_refs) if len(right_refs) != 1 else right_refs[0]
        return [_zip_blocks.remote(left, right)]


def _is_ref(obj: Any) -> bool:
    return isinstance(obj, local_tasks.ObjectRef)
