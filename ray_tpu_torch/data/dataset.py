"""Dataset: lazy distributed data transformations.

Port of ray_tpu's ``data/dataset.py`` (``Dataset``, ``GroupedData``,
``from_block_refs``): methods append logical ops; execution happens on
consumption (iter_*, take, count, write_*, materialize) through the
streaming executor, on the local task layer (``_private.local_tasks``).
Blocks are the port's dicts of numpy columns in the local object store.

The reference builds closures in its own methods (``select_columns``,
``drop_columns``, ``add_column``, ``random_sample``, ``map_groups``, and the
write tasks); the port's workers take functions by name, so each is a
module-level function bound with ``functools.partial``. Their behaviour is
the reference's, with one change of interface: ``add_column``'s ``fn``
receives the batch as a dict of numpy columns (the reference's a
``pyarrow.Table``) and returns the new column.

UDFs (``map``, ``map_batches``, ``flat_map``, ``filter``, ``map_groups``'
``fn``) run in the data workers and must be importable by name: a lambda or
a closure is refused with a ``TypeError`` when its task is submitted.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Iterator, Optional

import numpy as np

from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.data.block import (
    BlockAccessor, DataContext, _column, _import, concat, filter_block, num_rows, slice_block,
)
from ray_tpu_torch.data.iterator import DataIterator, streaming_split
from ray_tpu_torch.data._internal import shuffle as shuffle_mod
from ray_tpu_torch.data._internal.map_fn import BLOCK_FORMAT
from ray_tpu_torch.data._internal.plan import (
    Aggregate,
    Filter,
    FlatMap,
    Limit,
    LogicalPlan,
    MapBatches,
    MapRows,
    RandomShuffle,
    Repartition,
    Sort,
    Union,
    Zip,
    plan_stages,
)
from ray_tpu_torch.data._internal.stats import DatasetStats
from ray_tpu_torch.data._internal.streaming_executor import StreamingExecutor, _num_rows


# ---- the package's own UDFs (module level: workers import them by name) ----
def _select(block, cols: list):
    return {c: block[c] for c in cols}


def _drop(block, cols: list):
    return {c: v for c, v in block.items() if c not in cols}


def _add(block, name: str, fn: Callable):
    out = dict(block)
    out[name] = _column(fn(BlockAccessor(block).to_numpy()))
    return out


def _random_sample(block, fraction: float, seed: Optional[int]):
    rng = np.random.default_rng(seed)
    return filter_block(block, rng.random(num_rows(block)) < fraction)


def _apply_groups(block, key: str, fn: Callable):
    out = []
    values = shuffle_mod._key_values(block, key)
    for value in dict.fromkeys(values):
        group = filter_block(block, [v == value for v in values])
        result = fn(BlockAccessor.for_block(group).to_numpy())
        out.append(BlockAccessor.for_block(result).block)
    return concat(out) if out else slice_block(block, 0, 0)


@local_tasks.remote
def _write_block(block, out_path: str, fmt: str) -> str:
    table = BlockAccessor.for_block(block).to_arrow()
    if fmt == "parquet":
        _import("pyarrow.parquet").write_table(table, out_path)
    elif fmt == "csv":
        _import("pyarrow.csv").write_csv(table, out_path)
    elif fmt == "json":
        table.to_pandas().to_json(out_path, orient="records", lines=True)
    return out_path


@local_tasks.remote
def _write_tfrecords_block(block, out_path: str) -> str:
    from ray_tpu_torch.data._internal.tfrecord import encode_example, write_records

    accessor = BlockAccessor.for_block(block)
    write_records(out_path, (encode_example(row) for row in accessor.iter_rows()))
    return out_path


@local_tasks.remote
def _write_task(sink, task_index: int, *blocks):
    return sink.write([BlockAccessor.for_block(b).block for b in blocks],
                      {"task_index": task_index})


class Dataset:
    def __init__(self, plan: LogicalPlan):
        self._plan = plan
        self._materialized_refs: Optional[list] = None
        self._stats = DatasetStats()

    # ---- transformations (lazy) ----

    def _with_op(self, op) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._with_op(MapRows(fn=fn))

    def map_batches(
        self,
        fn: Any,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute: Optional[str] = None,
        fn_args: tuple = (),
        fn_kwargs: dict | None = None,
        fn_constructor_args: tuple = (),
        num_cpus: float = 1.0,
        concurrency: Optional[int] = None,
    ) -> "Dataset":
        if compute is None:
            compute = "actors" if isinstance(fn, type) else "tasks"
        if concurrency is not None:
            ctx = DataContext.get_current()
            ctx.actor_pool_max_size = max(ctx.actor_pool_max_size, concurrency)
        return self._with_op(
            MapBatches(
                fn=fn,
                batch_size=batch_size,
                batch_format=batch_format,
                compute=compute,
                fn_args=fn_args,
                fn_kwargs=fn_kwargs or {},
                fn_constructor_args=fn_constructor_args,
                num_cpus=num_cpus,
            )
        )

    def flat_map(self, fn: Callable[[dict], list]) -> "Dataset":
        return self._with_op(FlatMap(fn=fn))

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._with_op(Filter(fn=fn))

    def limit(self, n: int) -> "Dataset":
        return self._with_op(Limit(limit=n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_op(Repartition(num_blocks=num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with_op(RandomShuffle(seed=seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with_op(Sort(key=key, descending=descending))

    def groupby(self, key: Optional[str]) -> "GroupedData":
        return GroupedData(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with_op(Zip(other=other._refs()))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with_op(Union(others=[o._refs() for o in others]))

    def select_columns(self, cols: list[str]) -> "Dataset":
        return self.map_batches(functools.partial(_select, cols=list(cols)),
                                batch_format=BLOCK_FORMAT)

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self.map_batches(functools.partial(_drop, cols=list(cols)),
                                batch_format=BLOCK_FORMAT)

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        """``fn(batch)``, with the batch a dict of numpy columns, returns
        the new column's values."""
        return self.map_batches(functools.partial(_add, name=name, fn=fn),
                                batch_format=BLOCK_FORMAT)

    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        return self.map_batches(functools.partial(_random_sample, fraction=fraction, seed=seed),
                                batch_format=BLOCK_FORMAT)

    # ---- execution ----

    def _refs(self) -> list:
        if self._materialized_refs is None:
            executor = StreamingExecutor(plan_stages(self._plan))
            self._materialized_refs = executor.execute_to_refs()
            self._stats.replace_stages(executor.stage_stats)
        return self._materialized_refs

    def _streaming_refs(self) -> Iterator:
        if self._materialized_refs is not None:
            return iter(self._materialized_refs)
        executor = StreamingExecutor(plan_stages(self._plan))

        def run() -> Iterator:
            try:
                yield from executor.execute()
            finally:
                # The consumed run's operator stats feed ds.stats(): a
                # streamed dataset must not re-execute just to report.
                self._stats.replace_stages(executor.stage_stats)

        return run()

    def materialize(self) -> "Dataset":
        self._refs()
        return self

    def iterator(self) -> DataIterator:
        return DataIterator(self._streaming_refs, stats=self._stats)

    def iter_batches(self, **kwargs) -> Iterator:
        return self.iterator().iter_batches(**kwargs)

    def iter_torch_batches(self, **kwargs) -> Iterator:
        return self.iterator().iter_torch_batches(**kwargs)

    def iter_rows(self) -> Iterator[dict]:
        return self.iterator().iter_rows()

    def streaming_split(
        self,
        n: int,
        *,
        equal: bool = True,
        resume_from: dict | None = None,
    ) -> list[DataIterator]:
        return streaming_split(self._refs(), n, resume_from=resume_from)

    def split(self, n: int) -> list["Dataset"]:
        refs = self._refs()
        shards = [refs[i::n] for i in range(n)]
        return [from_block_refs(shard) for shard in shards]

    # ---- consumption ----

    def take(self, n: int = 20) -> list[dict]:
        rows: list[dict] = []
        for row in self.iter_rows():
            rows.append(row)
            if len(rows) >= n:
                break
        return rows

    def take_all(self) -> list[dict]:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        return sum(local_tasks.get([_num_rows.remote(r) for r in self._refs()]))

    def num_blocks(self) -> int:
        return len(self._refs())

    def schema(self):
        refs = self._refs()
        if not refs:
            return None
        return BlockAccessor.for_block(local_tasks.get(refs[0])).schema()

    def columns(self) -> list[str]:
        schema = self.schema()
        return list(schema.names) if schema is not None else []

    def to_pandas(self):
        pd = _import("pandas")
        frames = [BlockAccessor.for_block(b).to_pandas()
                  for b in local_tasks.get(self._refs())]
        frames = [f for f in frames if len(f)]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def to_arrow(self):
        return BlockAccessor(concat(local_tasks.get(self._refs()))).to_arrow()

    def stats(self) -> str:
        # Execute only if nothing has run yet: a consumed streaming run
        # already recorded its operator stats.
        if not self._stats.stages and self._materialized_refs is None:
            self._refs()
        return self._stats.summary_string()

    # aggregates
    def sum(self, on: str):
        return self._global_agg(shuffle_mod.Sum(on))

    def min(self, on: str):
        return self._global_agg(shuffle_mod.Min(on))

    def max(self, on: str):
        return self._global_agg(shuffle_mod.Max(on))

    def mean(self, on: str):
        return self._global_agg(shuffle_mod.Mean(on))

    def std(self, on: str):
        return self._global_agg(shuffle_mod.Std(on))

    def _global_agg(self, agg):
        out = self._with_op(Aggregate(key=None, aggs=[agg]))
        rows = out.take_all()
        return rows[0][agg.name] if rows else None

    def aggregate(self, *aggs):
        out = self._with_op(Aggregate(key=None, aggs=list(aggs)))
        rows = out.take_all()
        return rows[0] if rows else {}

    # ---- writes ----

    def write_parquet(self, path: str) -> None:
        self._write(path, "parquet")

    def write_csv(self, path: str) -> None:
        self._write(path, "csv")

    def write_json(self, path: str) -> None:
        self._write(path, "json")

    def _write(self, path: str, fmt: str) -> None:
        os.makedirs(path, exist_ok=True)
        refs = [
            _write_block.remote(block_ref, f"{path}/part-{i:05d}.{fmt}", fmt)
            for i, block_ref in enumerate(self._refs())
        ]
        local_tasks.get(refs)

    def write_tfrecords(self, path: str) -> None:
        """One TFRecord file of tf.Example protos per block (in-tree codec,
        no TensorFlow)."""
        os.makedirs(path, exist_ok=True)
        refs = [
            _write_tfrecords_block.remote(block_ref, f"{path}/part-{i:05d}.tfrecord")
            for i, block_ref in enumerate(self._refs())
        ]
        local_tasks.get(refs)

    def write_datasink(self, datasink) -> None:
        """Write through a custom Datasink plugin, which the write tasks
        receive pickled (a module-level class)."""
        datasink.on_write_start()
        try:
            refs = [
                _write_task.remote(datasink, i, block_ref)
                for i, block_ref in enumerate(self._refs())
            ]
            results = local_tasks.get(refs)
        except Exception as exc:
            datasink.on_write_failed(exc)
            raise
        datasink.on_write_complete(results)

    def __repr__(self):
        return f"Dataset(plan={self._plan.describe()})"


class GroupedData:
    """Dataset.groupby(key) result, as the reference's."""

    def __init__(self, ds: Dataset, key: Optional[str]):
        self._ds = ds
        self._key = key

    def _agg(self, *aggs) -> Dataset:
        return self._ds._with_op(Aggregate(key=self._key, aggs=list(aggs)))

    def aggregate(self, *aggs) -> Dataset:
        return self._agg(*aggs)

    def count(self) -> Dataset:
        return self._agg(shuffle_mod.Count())

    def sum(self, on: str) -> Dataset:
        return self._agg(shuffle_mod.Sum(on))

    def min(self, on: str) -> Dataset:
        return self._agg(shuffle_mod.Min(on))

    def max(self, on: str) -> Dataset:
        return self._agg(shuffle_mod.Max(on))

    def mean(self, on: str) -> Dataset:
        return self._agg(shuffle_mod.Mean(on))

    def std(self, on: str) -> Dataset:
        return self._agg(shuffle_mod.Std(on))

    def map_groups(self, fn: Callable) -> Dataset:
        """Apply fn to each whole group (hash-partitioned by key)."""
        shuffled = self._ds._with_op(
            Repartition(num_blocks=max(1, self._ds.num_blocks()))
        )
        # Hash-partition so each group lands wholly in one block.
        refs = shuffle_mod.shuffle_blocks(
            shuffled._refs(), max(1, len(shuffled._refs())), "hash", self._key
        )
        return from_block_refs(refs).map_batches(
            functools.partial(_apply_groups, key=self._key, fn=fn),
            batch_format=BLOCK_FORMAT, batch_size=None,
        )


def from_block_refs(refs: list) -> Dataset:
    from ray_tpu_torch.data._internal.plan import InputData

    ds = Dataset(LogicalPlan([InputData(blocks=list(refs))]))
    ds._materialized_refs = list(refs)
    return ds
