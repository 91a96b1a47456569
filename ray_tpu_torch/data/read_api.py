"""Read API: parallel datasource reads.

Port of ray_tpu's ``data/read_api.py`` (read_parquet, read_csv, read_json,
read_numpy, read_images, read_text, read_tfrecords, read_datasource, range,
range_tensor, from_items, from_numpy, from_arrow, from_pandas, from_torch,
from_huggingface). Each read_* builds a Read logical op whose read tasks
run on the local task layer; file lists are split across ``parallelism``
tasks.

The reference's read tasks and readers are closures; here they are
module-level functions bound with ``functools.partial`` (the workers import
them by name), with the same behaviour. ``read_parquet``, ``read_csv`` and
``read_json`` read through pyarrow (and pandas for JSON) and
``read_images`` through PIL, as the reference does; each raises
``ImportError`` naming the package where it is absent. ``range``,
``read_numpy``, ``read_text``, ``read_tfrecords`` and ``from_items`` need
numpy alone.
"""

from __future__ import annotations

import builtins
import functools
import glob as globmod
import os
from typing import Optional

import numpy as np

from ray_tpu_torch.data.block import BlockAccessor, DataContext, _import, _object_column
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data._internal.plan import InputData, LogicalPlan, Read


def _resolve_paths(paths) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: list[str] = []
    for path in paths:
        if os.path.isdir(path):
            for root, _, names in os.walk(path):
                files += [
                    os.path.join(root, n) for n in names if not n.startswith(".")
                ]
        elif any(ch in path for ch in "*?["):
            files += globmod.glob(path)
        else:
            files.append(path)
    return sorted(files)


def _split_files(files: list[str], parallelism: int) -> list[list[str]]:
    parallelism = min(parallelism, len(files)) or 1
    return [files[i::parallelism] for i in builtins.range(parallelism)]


def _read_files(chunk: list[str], reader):
    for path in chunk:
        yield reader(path)


def _file_dataset(paths, parallelism: int, reader, name: str) -> Dataset:
    files = _resolve_paths(paths)
    if not files:
        raise FileNotFoundError(f"no files matched {paths!r}")
    if parallelism <= 0:
        parallelism = min(DataContext.get_current().read_op_min_num_blocks, len(files))
    tasks = [functools.partial(_read_files, chunk, reader)
             for chunk in _split_files(files, parallelism)]
    return Dataset(LogicalPlan([Read(read_tasks=tasks, name=name)]))


# ---- readers (module level: the workers import them by name) ----
def _read_parquet_file(path, columns=None):
    return BlockAccessor.for_block(
        _import("pyarrow.parquet").read_table(path, columns=columns)).block


def _read_csv_file(path):
    return BlockAccessor.for_block(_import("pyarrow.csv").read_csv(path)).block


def _read_json_file(path, lines: bool = True):
    pd, pa = _import("pandas"), _import("pyarrow")
    df = pd.read_json(path, lines=lines)
    return BlockAccessor.for_block(pa.Table.from_pandas(df, preserve_index=False)).block


def _read_numpy_file(path, column: str = "data"):
    return BlockAccessor.for_block({column: np.load(path)}).block


def _read_image_file(path, size=None, mode: str = "RGB"):
    image_mod = _import("PIL.Image")
    img = image_mod.open(path).convert(mode)
    if size is not None:
        img = img.resize(size)
    arr = np.asarray(img)[None]  # [1, H, W, C]
    return BlockAccessor.for_block({"image": arr, "path": _object_column([path])}).block


def _read_text_file(path):
    with open(path) as f:
        lines = [line.rstrip("\n") for line in f]
    return BlockAccessor.for_block({"text": lines}).block


def _read_tfrecords_file(path: str):
    from ray_tpu_torch.data._internal.tfrecord import decode_example, read_records

    rows = [decode_example(rec) for rec in read_records(path)]
    if not rows:
        return {}
    # Union of feature names across all records (sparse/optional
    # features are normal in tf.Example data); missing -> null.
    names: list[str] = []
    for row in rows:
        for n in row:
            if n not in names:
                names.append(n)
    columns = {}
    for n in names:
        values = [r.get(n) for r in rows]
        # A column mixing unwrapped scalars and multi-element lists is
        # normalized to lists, as the reference's.
        if any(isinstance(v, list) for v in values):
            values = [v if isinstance(v, list) or v is None else [v] for v in values]
            columns[n] = _object_column(values)
        else:
            columns[n] = values
    return BlockAccessor.for_block(columns).block


def _range_block(lo: int, hi: int):
    yield BlockAccessor.for_block({"id": np.arange(lo, hi)}).block


def _to_tensor(batch, shape: tuple):
    ids = batch["id"]
    data = np.broadcast_to(
        ids.reshape((-1,) + (1,) * len(shape)), (len(ids),) + shape
    ).copy()
    return {"data": data}


# ---- the API ----
def read_parquet(paths, *, parallelism: int = -1, columns=None) -> Dataset:
    return _file_dataset(paths, parallelism,
                         functools.partial(_read_parquet_file, columns=columns), "ReadParquet")


def read_csv(paths, *, parallelism: int = -1) -> Dataset:
    return _file_dataset(paths, parallelism, _read_csv_file, "ReadCSV")


def read_json(paths, *, parallelism: int = -1, lines: bool = True) -> Dataset:
    return _file_dataset(paths, parallelism, functools.partial(_read_json_file, lines=lines),
                         "ReadJSON")


def read_numpy(paths, *, parallelism: int = -1, column: str = "data") -> Dataset:
    return _file_dataset(paths, parallelism, functools.partial(_read_numpy_file, column=column),
                         "ReadNumpy")


def read_images(
    paths, *, parallelism: int = -1, size: Optional[tuple] = None, mode: str = "RGB"
) -> Dataset:
    return _file_dataset(paths, parallelism,
                         functools.partial(_read_image_file, size=size, mode=mode), "ReadImages")


def read_text(paths, *, parallelism: int = -1) -> Dataset:
    return _file_dataset(paths, parallelism, _read_text_file, "ReadText")


def read_tfrecords(paths, *, parallelism: int = -1) -> Dataset:
    """Read TFRecord files of tf.Example protos; no TensorFlow needed:
    both wire formats are decoded by the in-tree codec
    (``_internal/tfrecord.py``)."""
    return _file_dataset(paths, parallelism, _read_tfrecords_file, "ReadTFRecords")


def read_datasource(datasource, *, parallelism: int = -1, **_unused) -> Dataset:
    """Read from a custom Datasource plugin, whose read tasks' functions
    must pickle by name."""
    if parallelism <= 0:
        parallelism = DataContext.get_current().read_op_min_num_blocks
    read_tasks = datasource.get_read_tasks(parallelism)
    if not read_tasks:
        return from_items([])
    return Dataset(
        LogicalPlan(
            [Read(read_tasks=list(read_tasks), name=f"Read{datasource.get_name()}")]
        )
    )


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    if parallelism <= 0:
        parallelism = min(DataContext.get_current().read_op_min_num_blocks, max(n, 1))
    edges = [round(i * n / parallelism) for i in builtins.range(parallelism + 1)]
    tasks = [functools.partial(_range_block, edges[i], edges[i + 1])
             for i in builtins.range(parallelism)]
    return Dataset(LogicalPlan([Read(read_tasks=tasks, name="ReadRange")]))


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    return range(n, parallelism=parallelism).map_batches(
        functools.partial(_to_tensor, shape=tuple(shape)))


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    rows = [
        item if isinstance(item, dict) else {"item": item} for item in items
    ]
    if parallelism <= 0:
        parallelism = min(DataContext.get_current().read_op_min_num_blocks, max(len(rows), 1))
    chunks = [rows[i::parallelism] for i in builtins.range(parallelism)]
    blocks = [
        BlockAccessor.for_block(chunk).block for chunk in chunks if chunk
    ]
    return Dataset(LogicalPlan([InputData(blocks=blocks)]))


def from_numpy(array, *, column: str = "data") -> Dataset:
    return Dataset(
        LogicalPlan([InputData(blocks=[BlockAccessor.for_block({column: array}).block])])
    )


def from_arrow(table) -> Dataset:
    return Dataset(LogicalPlan([InputData(blocks=[BlockAccessor.for_block(table).block])]))


def from_pandas(df) -> Dataset:
    return Dataset(
        LogicalPlan([InputData(blocks=[BlockAccessor.for_block(df).block])])
    )


def from_torch(torch_dataset) -> Dataset:
    rows = []
    for item in torch_dataset:
        rows.append({"item": item})
    return from_items(rows)


def from_huggingface(hf_dataset) -> Dataset:
    return from_arrow(hf_dataset.data.table)
