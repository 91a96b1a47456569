"""Blocks: the unit of data movement.

Port of ray_tpu's ``data/block.py`` (``BlockAccessor``, ``BlockBuilder``,
``BlockMetadata``, ``DataContext``). The reference's canonical block is a
``pyarrow.Table``; the port's is a columnar dict of numpy arrays,
``{name: ndarray}`` in column order, so that the data plane needs only
numpy and crosses processes with stdlib pickle alone (its arrays go as
out-of-band buffers, read back without a copy). A column is one of:

* a 1-D array of a numeric or bool dtype (arrow's primitive types);
* an N-D array, one row per leading index (arrow's nested fixed-size
  lists: a tensor column);
* a 1-D object array: strings, bytes, lists of unequal length, and any
  column holding ``None`` (arrow's nulls), kept as Python values.

Blocks are built from values the way the reference builds its tables
(``_normalize``, ``_column_to_arrow``): ``np.asarray`` first, a tensor
column where that has more than one dimension, arrow's inference for
object values (ints, floats, bools and strings, with or without ``None``),
numpy strings as Python strings. What comes out equals the reference's
``pa.Table`` path: ``to_numpy`` gives arrow's ``to_numpy`` (an int or float
column holding ``None`` comes back as float64 with NaN, a bool one as
objects), ``iter_rows`` arrow's ``to_pylist`` (tensor rows as nested lists,
nulls as ``None``), and ``schema()`` the column names with the dtype and
row shape ``to_numpy`` gives each.

``pyarrow`` and ``pandas`` are imported only by the calls that need them
(``to_arrow``, ``to_pandas``, blocks given as a table or a frame); where
the package is absent those raise ``ImportError`` naming it.
"""

from __future__ import annotations

import numbers
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

import numpy as np

Block = dict  # {column name: np.ndarray}


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[Any] = None
    input_files: list[str] = field(default_factory=list)
    exec_stats: Optional[dict] = None


@dataclass
class DataContext:
    """Global knobs, as the reference's ``DataContext``. The byte budget
    of streaming admission reads the local object store
    (``_private.local_tasks``): its used bytes against its capacity."""

    target_max_block_size: int = 128 * 1024 * 1024
    target_min_block_size: int = 1 * 1024 * 1024
    read_op_min_num_blocks: int = 8
    actor_pool_min_size: int = 1
    actor_pool_max_size: int = 4
    streaming_max_inflight_tasks: int = 8
    streaming_store_budget_fraction: float = 0.75
    eager_free: bool = True

    _current: "DataContext | None" = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._current is None:
            cls._current = cls()
        return cls._current


class Schema:
    """A block's column names, and for each the dtype and the per-row shape
    of the array ``to_numpy`` gives it."""

    def __init__(self, names: list[str], types: list[np.dtype], shapes: list[tuple]):
        self.names, self.types, self.shapes = list(names), list(types), list(shapes)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Schema) and self.names == other.names
                and self.types == other.types and self.shapes == other.shapes)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {t}{list(s) if s else ''}"
                         for n, t, s in zip(self.names, self.types, self.shapes))
        return f"Schema({cols})"


def _import(name: str):
    """``pyarrow`` or ``pandas``, or an ImportError that names it."""
    import importlib

    try:
        return importlib.import_module(name)
    except ImportError as exc:
        raise ImportError(f"this call needs {name}, which is not installed: {exc}") from exc


# ------------------------------------------------------------ block functions
def num_rows(block: Block) -> int:
    for col in block.values():
        return len(col)
    return 0


def slice_block(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def take(block: Block, indices) -> Block:
    idx = np.asarray(indices, dtype=np.int64)
    return {k: v[idx] for k, v in block.items()}


def filter_block(block: Block, mask) -> Block:
    mask = np.asarray(mask, dtype=bool)
    return {k: v[mask] for k, v in block.items()}


def sort_indices(col: np.ndarray, descending: bool = False) -> np.ndarray:
    """A stable sort's order (ties keep their order, as arrow's sort)."""
    if not descending:
        return np.argsort(col, kind="stable")
    n = len(col)
    return (n - 1 - np.argsort(col[::-1], kind="stable"))[::-1]


def _py(value: Any) -> Any:
    return value.item() if isinstance(value, np.generic) else value


def _object_column(values: list) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _from_objects(values: list) -> np.ndarray:
    """A column from Python values, as ``pa.array(values)`` types them:
    all bools a bool column, all ints an int64 one, ints and floats a
    float64 one; anything else (strings, bytes, lists, or any ``None``)
    an object column of the values."""
    values = [_py(v) for v in values]
    if None not in values and values:
        if all(isinstance(v, bool) for v in values):
            return np.array(values, dtype=bool)
        if all(isinstance(v, numbers.Integral) and not isinstance(v, bool) for v in values):
            return np.array(values, dtype=np.int64)
        if all(isinstance(v, numbers.Real) and not isinstance(v, bool) for v in values):
            return np.array(values, dtype=np.float64)
    return _object_column(values)


def _column(values: Any) -> np.ndarray:
    """One column of a block from array-like values (the reference's
    ``_column_to_arrow``)."""
    if isinstance(values, np.ndarray) and values.dtype != object \
            and values.dtype.kind not in "US":
        return values
    if type(values).__module__.startswith("pyarrow"):
        return _arrow_column(values)
    if type(values).__module__.startswith("pandas"):
        values = values.to_numpy()
    arr = np.asarray(values)
    if arr.ndim > 1:
        return arr
    if arr.dtype == object:
        return _from_objects(list(values))
    if arr.dtype.kind in "US":
        return arr.astype(object)
    return arr


def _rows_to_block(rows: list[dict]) -> Block:
    if not rows:
        return {}
    columns: dict[str, list] = {k: [] for k in rows[0]}
    for row in rows:
        for key in columns:
            columns[key].append(row.get(key))
    return _normalize(columns)


def _normalize(block: Any) -> Block:
    """A block in the canonical form from a dict of columns, a list of
    rows, a ``pyarrow.Table`` or a ``pandas.DataFrame``."""
    if isinstance(block, dict):
        out = {name: _column(values) for name, values in block.items()}
        lengths = {len(v) for v in out.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")
        return out
    if isinstance(block, list):
        return _rows_to_block(block)
    module = type(block).__module__
    if module.startswith("pyarrow"):
        return {name: _arrow_column(block.column(name)) for name in block.column_names}
    if module.startswith("pandas"):
        return {str(name): _column(block[name].to_numpy()) for name in block.columns}
    raise TypeError(f"cannot treat {type(block).__name__} as a block")


def _arrow_column(col) -> np.ndarray:
    """A pyarrow Array or ChunkedArray as a column: nested fixed-size lists
    as a tensor column, nulls and lists kept as Python values."""
    pa = _import("pyarrow")
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if col.null_count == 0 and pa.types.is_fixed_size_list(col.type):
        shape, values, atype = [], col, col.type
        while pa.types.is_fixed_size_list(atype):
            shape.append(atype.list_size)
            values, atype = values.flatten(), atype.value_type
        if values.null_count == 0 and not (pa.types.is_list(atype)
                                           or pa.types.is_struct(atype)):
            return _column(values.to_numpy(zero_copy_only=False)).reshape((len(col), *shape))
    if col.null_count or not (pa.types.is_primitive(col.type) or pa.types.is_string(col.type)
                              or pa.types.is_binary(col.type)):
        return _object_column(col.to_pylist())
    return _column(col.to_numpy(zero_copy_only=False))


def _column_to_numpy(col: np.ndarray) -> np.ndarray:
    """The array arrow's ``to_numpy(zero_copy_only=False)`` gives for the
    column (the reference's ``_chunked_to_numpy``)."""
    if col.dtype != object:
        return col
    present = [v for v in col if v is not None]
    if len(present) < len(col) and present:
        if all(isinstance(v, numbers.Real) and not isinstance(v, bool) for v in present):
            return np.array([np.nan if v is None else v for v in col], dtype=np.float64)
    if any(isinstance(v, list) for v in present):
        return np.asarray(col.tolist(), dtype=object)
    return col


def concat(blocks: list) -> Block:
    """Concatenates blocks, skipping empty ones (arrow's
    ``concat_tables(promote_options="permissive")``: a column a block lacks
    is null there)."""
    parts = [b for b in (_normalize(b) for b in blocks) if num_rows(b) > 0]
    if not parts:
        return {}
    if len(parts) == 1:
        return parts[0]
    names: list[str] = []
    for part in parts:
        names += [n for n in part if n not in names]
    out = {}
    for name in names:
        cols = [p[name] if name in p else _object_column([None] * num_rows(p)) for p in parts]
        out[name] = np.concatenate(cols)
    return out


# ------------------------------------------------------------ the interface
class BlockAccessor:
    """Normalized view over any block representation."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Any) -> "BlockAccessor":
        return BlockAccessor(_normalize(block))

    @property
    def block(self) -> Block:
        return self._block

    def num_rows(self) -> int:
        return num_rows(self._block)

    def size_bytes(self) -> int:
        total = 0
        for col in self._block.values():
            total += col.nbytes
            if col.dtype == object:
                total += sum(len(v) for v in col if isinstance(v, (str, bytes)))
        return total

    def schema(self) -> Schema:
        arrays = self.to_numpy()
        return Schema(list(arrays), [a.dtype for a in arrays.values()],
                      [tuple(a.shape[1:]) for a in arrays.values()])

    def metadata(self, input_files: list[str] | None = None) -> BlockMetadata:
        return BlockMetadata(num_rows=self.num_rows(), size_bytes=self.size_bytes(),
                             schema=self.schema(), input_files=input_files or [])

    def to_arrow(self):
        """The block as the reference's ``pa.Table`` (needs pyarrow)."""
        pa = _import("pyarrow")
        arrays = {}
        for name, col in self._block.items():
            if col.ndim > 1:
                out = pa.array(col.reshape(-1))
                for dim in reversed(col.shape[1:]):
                    out = pa.FixedSizeListArray.from_arrays(out, dim)
            elif col.dtype == object:
                out = pa.array(list(col))
            else:
                out = pa.array(col)
            arrays[name] = out
        return pa.table(arrays)

    def to_pandas(self):
        """The block as a ``pandas.DataFrame`` (needs pandas): tensor rows
        as arrays, nulls as the column's missing value."""
        pd = _import("pandas")
        return pd.DataFrame({name: (_column_to_numpy(col) if col.ndim == 1 else list(col))
                             for name, col in self._block.items()})

    def to_numpy(self, columns: list[str] | None = None) -> dict[str, np.ndarray]:
        names = columns or list(self._block)
        return {name: _column_to_numpy(self._block[name]) for name in names}

    def iter_rows(self) -> Iterator[dict]:
        names = list(self._block)
        cols = [self._block[n].tolist() for n in names]
        for values in zip(*cols):
            yield dict(zip(names, values))

    def slice(self, start: int, end: int) -> Block:
        return slice_block(self._block, start, end)

    def take(self, indices) -> Block:
        return take(self._block, indices)

    def select(self, columns: list[str]) -> Block:
        return {name: self._block[name] for name in columns}

    def sample(self, n: int, rng: np.random.Generator) -> Block:
        n = min(n, self.num_rows())
        idx = rng.choice(self.num_rows(), size=n, replace=False)
        return self.take(np.sort(idx))

    @staticmethod
    def concat(blocks: list[Any]) -> Block:
        return concat(blocks)

    @staticmethod
    def builder() -> "BlockBuilder":
        return BlockBuilder()


class BlockBuilder:
    """Accumulate rows/batches, emit blocks at a target size."""

    def __init__(self):
        self._blocks: list[Block] = []
        self._rows: list[dict] = []
        self._size = 0

    def add_row(self, row: dict) -> None:
        self._rows.append(row)
        self._size += sum(_rough_size(v) for v in row.values())

    def add_block(self, block: Any) -> None:
        block = _normalize(block)
        if num_rows(block):
            self._blocks.append(block)
            self._size += BlockAccessor(block).size_bytes()

    def size_bytes(self) -> int:
        return self._size

    def num_rows(self) -> int:
        return sum(num_rows(b) for b in self._blocks) + len(self._rows)

    def build(self) -> Block:
        if self._rows:
            self._blocks.append(_rows_to_block(self._rows))
            self._rows = []
        if not self._blocks:
            return {}
        out = concat(self._blocks)
        self._blocks = [out]
        return out


def _rough_size(value: Any) -> int:
    if isinstance(value, np.ndarray):
        return value.nbytes
    if isinstance(value, (bytes, str)):
        return len(value)
    return 8

