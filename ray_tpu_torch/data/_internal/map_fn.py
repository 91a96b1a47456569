"""Fused map-chain application: the body of every map task.

Port of ray_tpu's ``data/_internal/map_fn.py``: one function that applies a
fused run of map-like logical ops to one block, including batch slicing and
format conversion for map_batches UDFs. Blocks are the port's dicts of
numpy columns (``data.block``); a ``"pyarrow"`` or ``"pandas"`` batch is
converted for the UDF, which needs that package.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

from ray_tpu_torch.data.block import (
    Block, BlockAccessor, BlockBuilder, _normalize, num_rows, slice_block,
)
from ray_tpu_torch.data._internal.plan import Filter, FlatMap, MapBatches, MapRows

# The batch format of the package's own UDFs (select, drop and add columns,
# random_sample, map_groups) and of iter_rows: the block itself, where the
# reference hands its own code a pyarrow table.
BLOCK_FORMAT = "_block"


def format_batch(block: Block, batch_format: str) -> Any:
    if batch_format == BLOCK_FORMAT:
        return block
    if batch_format in ("numpy", "default", None):
        return BlockAccessor(block).to_numpy()
    if batch_format == "pandas":
        return BlockAccessor(block).to_pandas()
    if batch_format in ("pyarrow", "arrow"):
        return BlockAccessor(block).to_arrow()
    raise ValueError(f"unknown batch_format {batch_format!r}")


def batch_blocks(block: Block, batch_size: int | None) -> Iterator[Block]:
    rows = num_rows(block)
    if batch_size is None or rows <= batch_size:
        if rows:
            yield block
        return
    for start in range(0, rows, batch_size):
        yield slice_block(block, start, min(start + batch_size, rows))


def _apply_map_batches(op: MapBatches, fn: Callable, block: Block) -> Block:
    builder = BlockBuilder()
    for batch in batch_blocks(block, op.batch_size):
        formatted = format_batch(batch, op.batch_format)
        out = fn(formatted, *op.fn_args, **op.fn_kwargs)
        if out is None:
            continue
        # UDFs may yield multiple output batches (generator UDF).
        outs = out if isinstance(out, Iterator) else [out]
        for item in outs:
            builder.add_block(_normalize(item))
    return builder.build()


def _apply_rowwise(op, block: Block) -> Block:
    rows = list(BlockAccessor(block).iter_rows())
    if isinstance(op, MapRows):
        new_rows = [op.fn(row) for row in rows]
    elif isinstance(op, FlatMap):
        new_rows = [out for row in rows for out in op.fn(row)]
    elif isinstance(op, Filter):
        new_rows = [row for row in rows if op.fn(row)]
    else:
        raise TypeError(op)
    if not new_rows:
        return slice_block(block, 0, 0)
    builder = BlockBuilder()
    for row in new_rows:
        builder.add_row(row)
    return builder.build()


def make_fused_fn(ops: list, udf_instances: dict[int, Callable] | None = None):
    """Build block -> block applying the fused chain. ``udf_instances`` maps
    op index -> constructed callable for actor-compute MapBatches classes."""

    def fused(block) -> Block:
        block = _normalize(block)
        for idx, op in enumerate(ops):
            if isinstance(op, MapBatches):
                fn = (udf_instances or {}).get(idx)
                if fn is None:
                    fn = op.fn
                    if isinstance(fn, type):
                        fn = fn(*op.fn_constructor_args)
                block = _apply_map_batches(op, fn, block)
            else:
                block = _apply_rowwise(op, block)
        return block

    return fused


def instantiate_udfs(ops: list) -> dict[int, Callable]:
    """Construct stateful UDF classes once (actor-pool compute)."""
    instances: dict[int, Callable] = {}
    for idx, op in enumerate(ops):
        if isinstance(op, MapBatches) and isinstance(op.fn, type):
            instances[idx] = op.fn(*op.fn_constructor_args)
    return instances
