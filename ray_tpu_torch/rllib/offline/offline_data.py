"""OfflineData — dataset-backed training input.

A copy of ray_tpu's ``rllib/offline/offline_data.py``: experience comes
from a dataset instead of env runners. Rows are per-timestep records with
SampleBatch column names ("obs", "actions", optionally "rewards",
"new_obs", "terminateds", "action_logp").

The reference reads a path through its runtime's ``data.read_json`` /
``read_parquet``; the port has no data runtime, so:

  * a path ending in ``.json`` or ``.jsonl`` is read as JSON lines (one
    object a line), as the reference's ``read_json(lines=True)`` reads
    both, with the standard library;
  * any other path is parquet, read with ``pyarrow.parquet`` (imported
    where it is read);
  * a path may be a file, a directory (every file under it not starting
    with ".", in sorted order) or a glob, as the reference resolves it;
  * any object with ``take_all`` (a dataset) is read through it.

Rows become columns by the reference's rule (``_rows_to_batch``), and the
epoch order comes from ``default_rng(shuffle_seed)``, so both packages
draw the same minibatches from the same rows.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


def _resolve_paths(path: str) -> list[str]:
    if os.path.isdir(path):
        files = [os.path.join(root, name) for root, _, names in os.walk(path)
                 for name in names if not name.startswith(".")]
    elif any(ch in path for ch in "*?["):
        files = glob.glob(path)
    else:
        files = [path]
    if not files:
        raise FileNotFoundError(f"no files matched {path!r}")
    return sorted(files)


def _read_rows(path: str) -> list[dict]:
    rows: list[dict] = []
    for file in _resolve_paths(path):
        if path.endswith(".json") or path.endswith(".jsonl"):
            with open(file) as f:
                rows += [json.loads(line) for line in f if line.strip()]
        else:
            import pyarrow.parquet as pq

            rows += pq.read_table(file).to_pylist()
    return rows


class OfflineData:
    def __init__(self, source: Any, shuffle_seed: int | None = 0):
        self._batch = self._load(source)
        self._rng = np.random.default_rng(shuffle_seed)
        self._order = np.arange(len(self._batch))
        self._cursor = len(self._batch)  # force shuffle on first sample

    @staticmethod
    def _load(source: Any) -> SampleBatch:
        if isinstance(source, SampleBatch):
            return source
        if isinstance(source, dict):
            return SampleBatch(source)
        if isinstance(source, str):
            return OfflineData._rows_to_batch(_read_rows(source))
        if hasattr(source, "take_all"):  # a dataset
            return OfflineData._rows_to_batch(source.take_all())
        raise TypeError(f"unsupported offline input: {type(source)!r}")

    @staticmethod
    def _rows_to_batch(rows: list[dict]) -> SampleBatch:
        if not rows:
            raise ValueError("offline dataset is empty")
        cols: dict[str, list] = {k: [] for k in rows[0]}
        for row in rows:
            for key, value in row.items():
                cols[key].append(value)
        return SampleBatch({k: np.asarray(v) for k, v in cols.items()})

    def __len__(self) -> int:
        return len(self._batch)

    @property
    def columns(self):
        return self._batch.keys()

    def sample(self, batch_size: int) -> SampleBatch:
        """Epoch-shuffled minibatch (reshuffles when the epoch wraps)."""
        if self._cursor + batch_size > len(self._order):
            self._rng.shuffle(self._order)
            self._cursor = 0
        idx = self._order[self._cursor : self._cursor + batch_size]
        self._cursor += batch_size
        return SampleBatch({k: v[idx] for k, v in self._batch.items()})
