"""Experiment-tracker sinks for Tune.

Role-equivalent of python/ray/air/integrations/{wandb,mlflow}.py ::
WandbLoggerCallback / MLflowLoggerCallback (SURVEY §2.5): a tracker
observes every trial as a *run* — params once at add time, a metric
stream per report, a terminal status — decoupled from Tune's own result
logging. The W&B/MLflow network services don't exist in this image, so
the shipped implementation is file-backed with their run/params/metrics
data model; pointing a real backend at the same interface is a subclass
away (override the four _backend hooks).

Register like any logger callback:

    tune.Tuner(..., run_config=RunConfig(
        callbacks=[FileTrackerCallback(root_dir)],
    ))

Copied from ray_tpu's ``air/integrations.py``, on the port's
``tune/logger.py`` and the atomic JSON write of its
``tune/experiment/trial.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from ray_tpu_torch.tune.experiment.trial import atomic_write_json
from ray_tpu_torch.tune.logger import LoggerCallback


class TrackerCallback(LoggerCallback):
    """Tracker-shaped adapter over the trial lifecycle: subclasses
    implement run start/metrics/end against their backend; param and
    metric filtering/flattening is shared here."""

    def __init__(self, *, flatten_sep: str = "/"):
        self._sep = flatten_sep
        self._started: set[str] = set()

    # -- backend hooks (the integration surface) ------------------------
    def _backend_start_run(self, run_id: str, name: str, params: dict) -> None:
        raise NotImplementedError

    def _backend_log_metrics(self, run_id: str, step: int, metrics: dict) -> None:
        raise NotImplementedError

    def _backend_end_run(self, run_id: str, status: str) -> None:
        raise NotImplementedError

    # -- trial lifecycle -> run lifecycle -------------------------------
    def on_trial_add(self, trial) -> None:
        self._ensure_started(trial)

    def _ensure_started(self, trial) -> None:
        if trial.trial_id in self._started:
            return
        self._started.add(trial.trial_id)
        self._backend_start_run(
            trial.trial_id,
            getattr(trial, "experiment_tag", None) or trial.trial_id,
            self._flatten(dict(trial.config or {})),
        )

    def on_trial_result(self, trial, result: dict) -> None:
        self._ensure_started(trial)
        step = int(result.get("training_iteration", 0))
        metrics = {
            k: v
            for k, v in self._flatten(result).items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        if metrics:
            self._backend_log_metrics(trial.trial_id, step, metrics)

    def on_trial_complete(self, trial, result: dict) -> None:
        if trial.trial_id in self._started:
            self._started.discard(trial.trial_id)
            self._backend_end_run(trial.trial_id, "FINISHED")

    def on_trial_error(self, trial) -> None:
        if trial.trial_id in self._started:
            self._started.discard(trial.trial_id)
            self._backend_end_run(trial.trial_id, "FAILED")

    # -- shared shaping -------------------------------------------------
    def _flatten(self, mapping: dict, prefix: str = "") -> dict:
        out: dict[str, Any] = {}
        for key, value in mapping.items():
            name = f"{prefix}{self._sep}{key}" if prefix else str(key)
            if isinstance(value, dict):
                out.update(self._flatten(value, name))
            else:
                out[name] = value
        return out


class FileTrackerCallback(TrackerCallback):
    """File-backed tracker with the W&B/MLflow run data model:

        <root>/<run_id>/run.json       {run_id, name, status, timestamps}
        <root>/<run_id>/params.json    flattened trial config
        <root>/<run_id>/metrics.jsonl  one {step, ts, **metrics} per report
    """

    def __init__(self, root_dir: str, **kwargs):
        super().__init__(**kwargs)
        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)

    def _run_dir(self, run_id: str) -> str:
        d = os.path.join(self.root_dir, run_id)
        os.makedirs(d, exist_ok=True)
        return d

    def _backend_start_run(self, run_id, name, params) -> None:
        d = self._run_dir(run_id)
        atomic_write_json(
            os.path.join(d, "run.json"),
            {
                "run_id": run_id,
                "name": name,
                "status": "RUNNING",
                "start_time": time.time(),
            },
        )
        atomic_write_json(
            os.path.join(d, "params.json"),
            {k: v if _jsonable(v) else repr(v) for k, v in params.items()},
        )

    def _backend_log_metrics(self, run_id, step, metrics) -> None:
        with open(
            os.path.join(self._run_dir(run_id), "metrics.jsonl"), "a"
        ) as f:
            f.write(json.dumps({"step": step, "ts": time.time(), **metrics}))
            f.write("\n")

    def _backend_end_run(self, run_id, status) -> None:
        path = os.path.join(self._run_dir(run_id), "run.json")
        try:
            with open(path) as f:
                run = json.load(f)
        except (OSError, ValueError):
            run = {"run_id": run_id}
        run["status"] = status
        run["end_time"] = time.time()
        atomic_write_json(path, run)


def _jsonable(value) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
