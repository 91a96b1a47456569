"""All-to-all stages: repartition, random_shuffle, sort, groupby-aggregate.

Port of ray_tpu's ``data/_internal/shuffle.py``: a map wave partitions each
input block into N parts, a reduce wave concatenates each partition's parts;
all parts move through the object store (``_private.local_tasks``). The
seeded split and merge, ``_stable_hash``, the sort's sample bounds and the
aggregates are the reference's, so a seeded ``random_shuffle`` over the
same block layout gives the reference's row order bit for bit.

One difference: with one output partition the split task returns its one
part itself. The reference's returns a list of one part under
``num_returns=1``, whose merge then fails, so ``repartition(1)`` and the
shuffle or sort of a one-block dataset raise there (ROADMAP Queue C).

Aggregates read the port's numpy columns where the reference calls
``pyarrow.compute``: ``Sum``, ``Min``, ``Max`` and ``Count`` give the same
values, ``Mean`` and ``Std`` (population, as arrow's ``stddev``) the same to
float rounding; nulls are skipped, as arrow skips them.
"""

from __future__ import annotations

import zlib
from typing import Any, Optional

import numpy as np

from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.data.block import (
    Block, BlockAccessor, _column_to_numpy, concat, filter_block, num_rows, slice_block,
    sort_indices, take,
)


def _stable_hash(v) -> int:
    """Deterministic across processes. The builtin hash() is per-process
    salted for str/bytes, and _split_block runs in different workers: the
    same groupby key would land in different partitions."""
    if isinstance(v, bytes):
        data = v
    elif isinstance(v, str):
        data = v.encode()
    else:
        data = repr(v).encode()
    return zlib.crc32(data)


def _key_values(block: Block, key: str) -> list:
    """A key column's values as the reference's pandas ``map`` sees them."""
    return _column_to_numpy(block[key]).tolist()


@local_tasks.remote
def _split_block(block, num_parts: int, mode: str, key, seed):
    """Map side. mode: 'slice' (repartition), 'random', 'range' (sort,
    key+bounds), 'hash' (groupby)."""
    n = num_rows(block)
    if mode == "slice":
        # Even contiguous split; reducer i gets rows [i*n/N, (i+1)*n/N).
        cuts = [round(i * n / num_parts) for i in range(num_parts + 1)]
        parts = [slice_block(block, cuts[i], cuts[i + 1]) for i in range(num_parts)]
        return parts[0] if num_parts == 1 else parts
    if mode == "random":
        rng = np.random.default_rng(seed)
        assignment = rng.integers(0, num_parts, size=n)
    elif mode == "range":
        bounds = key["bounds"]
        col = _column_to_numpy(block[key["key"]])
        assignment = np.searchsorted(bounds, col, side="right")
        if key.get("descending"):
            assignment = (num_parts - 1) - assignment
    elif mode == "hash":
        assignment = np.array([_stable_hash(v) % num_parts for v in _key_values(block, key)],
                              dtype=np.int64)
    else:
        raise ValueError(mode)
    parts = [take(block, np.nonzero(assignment == i)[0]) for i in range(num_parts)]
    return parts[0] if num_parts == 1 else parts


@local_tasks.remote
def _merge_parts(mode: str, key, seed, *parts):
    """Reduce side: concat my parts (+ per-mode post-processing)."""
    block = concat(list(parts))
    if mode == "random" and num_rows(block):
        rng = np.random.default_rng(seed)
        block = take(block, rng.permutation(num_rows(block)))
    elif mode == "range" and num_rows(block):
        block = take(block, sort_indices(_column_to_numpy(block[key["key"]]),
                                         bool(key.get("descending"))))
    return block


def shuffle_blocks(
    block_refs: list,
    num_out: int,
    mode: str,
    key: Any = None,
    seed: Optional[int] = None,
) -> list:
    """Run the 2-wave shuffle; returns num_out output block refs."""
    if not block_refs:
        return []
    part_lists = [
        _split_block.options(num_returns=num_out).remote(
            ref, num_out, mode, key, None if seed is None else seed + i
        )
        for i, ref in enumerate(block_refs)
    ]
    if num_out == 1:
        part_lists = [[p] for p in part_lists]
    out = []
    for j in range(num_out):
        parts_j = [parts[j] for parts in part_lists]
        out.append(
            _merge_parts.remote(
                mode, key, None if seed is None else seed + 7919 * (j + 1), *parts_j
            )
        )
    return out


@local_tasks.remote
def _sample(block, sort_key: str, k: int):
    if not num_rows(block):
        return np.array([])
    rng = np.random.default_rng(0)
    idx = rng.choice(num_rows(block), size=min(k, num_rows(block)), replace=False)
    return _column_to_numpy(take(block, np.sort(idx))[sort_key])


def sample_sort_bounds(block_refs: list, sort_key: str, num_out: int) -> np.ndarray:
    """Range-partition boundaries from a uniform sample (the reference's
    boundary sampling)."""
    samples = local_tasks.get([_sample.remote(ref, sort_key, 64) for ref in block_refs])
    merged = np.sort(np.concatenate([s for s in samples if len(s)] or [np.array([])]))
    if not len(merged):
        return np.array([])
    quantiles = [
        merged[min(len(merged) - 1, int(len(merged) * q / num_out))]
        for q in range(1, num_out)
    ]
    return np.asarray(quantiles)


# ---- groupby aggregation ----

def _present(block: Block, on: str) -> np.ndarray:
    """A column's non-null values (arrow's aggregates skip nulls)."""
    col = block[on]
    if col.dtype == object:
        return np.asarray([v for v in col if v is not None])
    return col


class AggregateFn:
    """name/accumulate(block)."""

    def __init__(self, name: str, on: Optional[str]):
        self.name = name
        self.on = on

    def accumulate(self, block: Block):
        raise NotImplementedError


class Count(AggregateFn):
    def __init__(self):
        super().__init__("count()", None)

    def accumulate(self, block: Block):
        return num_rows(block)


class _ColumnAgg(AggregateFn):
    _pc_fn: str = ""

    def __init__(self, on: str):
        super().__init__(f"{self._pc_fn}({on})", on)

    def accumulate(self, block: Block):
        values = _present(block, self.on)
        if not len(values):
            return None
        out = self._reduce(values)
        return out.item() if isinstance(out, np.generic) else out

    def _reduce(self, values: np.ndarray):
        raise NotImplementedError


class Sum(_ColumnAgg):
    _pc_fn = "sum"

    def _reduce(self, values):
        return values.sum()


class Min(_ColumnAgg):
    _pc_fn = "min"

    def _reduce(self, values):
        return values.min()


class Max(_ColumnAgg):
    _pc_fn = "max"

    def _reduce(self, values):
        return values.max()


class Mean(_ColumnAgg):
    _pc_fn = "mean"

    def _reduce(self, values):
        return float(values.mean(dtype=np.float64))


class Std(_ColumnAgg):
    _pc_fn = "stddev"

    def _reduce(self, values):
        return float(values.std(dtype=np.float64))


@local_tasks.remote
def _agg_partition(key: Optional[str], aggs: list, *parts):
    block = concat(list(parts))
    if num_rows(block) == 0:
        return block
    if key is None:
        row = {a.name: a.accumulate(block) for a in aggs}
        return BlockAccessor.for_block([row]).block
    out_rows = []
    # Partition is hash-complete per key: group locally, in first-seen order.
    values = _key_values(block, key)
    for value in dict.fromkeys(values):
        group = filter_block(block, [v == value for v in values])
        row = {key: value}
        for agg in aggs:
            row[agg.name] = agg.accumulate(group)
        out_rows.append(row)
    out_rows.sort(key=lambda r: (r[key] is None, r[key]))
    return BlockAccessor.for_block(out_rows).block


def groupby_aggregate(
    block_refs: list, key: Optional[str], aggs: list, num_out: int
) -> list:
    if not block_refs:
        return []
    if key is None:
        # Global aggregate: one reduce task over every block.
        return [_agg_partition.remote(None, aggs, *block_refs)]
    num_out = min(num_out, len(block_refs)) or 1
    part_lists = [
        _split_block.options(num_returns=num_out).remote(ref, num_out, "hash", key, None)
        for ref in block_refs
    ]
    if num_out == 1:
        part_lists = [[p] for p in part_lists]
    return [
        _agg_partition.remote(key, aggs, *[parts[j] for parts in part_lists])
        for j in range(num_out)
    ]
