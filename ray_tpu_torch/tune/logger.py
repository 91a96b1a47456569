"""Per-trial metric sinks.

Role-equivalent of python/ray/tune/logger/{csv,json,tensorboardx}.py —
callbacks the controller fires on every trial event. TensorBoard support
writes tfevents via a minimal record writer only if tensorboardX is
importable; CSV/JSONL always work.

Copied from ray_tpu's ``tune/logger.py``.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import IO


class LoggerCallback:
    def on_trial_add(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: dict) -> None:
        pass

    def on_trial_complete(self, trial, result: dict) -> None:
        pass

    def on_trial_error(self, trial) -> None:
        pass


class JsonLoggerCallback(LoggerCallback):
    """result.json — one JSON line per reported result (reference format)."""

    def __init__(self):
        self._files: dict[str, IO] = {}

    def on_trial_result(self, trial, result: dict) -> None:
        f = self._files.get(trial.trial_id)
        if f is None:
            f = open(os.path.join(trial.local_dir, "result.json"), "a")
            self._files[trial.trial_id] = f
        payload = {k: v for k, v in result.items() if _jsonable(v)}
        payload["timestamp"] = time.time()
        f.write(json.dumps(payload) + "\n")
        f.flush()

    def on_trial_complete(self, trial, result: dict) -> None:
        f = self._files.pop(trial.trial_id, None)
        if f:
            f.close()


class CSVLoggerCallback(LoggerCallback):
    """progress.csv — header from the first result's keys."""

    def __init__(self):
        self._writers: dict[str, tuple[IO, csv.DictWriter]] = {}

    def on_trial_result(self, trial, result: dict) -> None:
        flat = {k: v for k, v in result.items() if _scalar(v)}
        entry = self._writers.get(trial.trial_id)
        if entry is None:
            f = open(os.path.join(trial.local_dir, "progress.csv"), "a", newline="")
            writer = csv.DictWriter(f, fieldnames=sorted(flat))
            writer.writeheader()
            self._writers[trial.trial_id] = (f, writer)
        else:
            f, writer = entry
        self._writers[trial.trial_id][1].writerow(
            {k: flat.get(k, "") for k in self._writers[trial.trial_id][1].fieldnames}
        )
        f.flush()

    def on_trial_complete(self, trial, result: dict) -> None:
        entry = self._writers.pop(trial.trial_id, None)
        if entry:
            entry[0].close()


class TBXLoggerCallback(LoggerCallback):
    """TensorBoard scalars (reference: logger/tensorboardx.py). Prefers
    tensorboardX; falls back to torch.utils.tensorboard (present in this
    image), so real tfevents files are written without extra deps."""

    def __init__(self):
        self._writer_cls = None
        self._dir_kw = "logdir"
        try:
            from tensorboardX import SummaryWriter  # noqa: F401

            self._writer_cls = SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer_cls = SummaryWriter
                self._dir_kw = "log_dir"
            except ImportError:
                pass
        self._writers: dict[str, object] = {}

    def on_trial_result(self, trial, result: dict) -> None:
        if self._writer_cls is None:
            return
        writer = self._writers.get(trial.trial_id)
        if writer is None:
            writer = self._writer_cls(**{self._dir_kw: trial.local_dir})
            self._writers[trial.trial_id] = writer
        step = result.get("training_iteration", 0)
        for key, value in result.items():
            if _scalar(value) and not isinstance(value, (str, bool)):
                writer.add_scalar(f"ray_tpu/tune/{key}", value, step)

    def on_trial_complete(self, trial, result: dict) -> None:
        writer = self._writers.pop(trial.trial_id, None)
        if writer is not None:
            writer.close()


def _scalar(value) -> bool:
    return isinstance(value, (int, float, str, bool))


def _jsonable(value) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
