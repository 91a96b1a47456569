"""Trial — one hyperparameter configuration's lifecycle.

Role-equivalent of python/ray/tune/experiment/trial.py :: Trial. FSM:
PENDING → RUNNING ⇄ PAUSED → TERMINATED | ERROR. The controller owns all
transitions; this object is pure state (serializable for experiment resume).

Copied from ray_tpu's ``tune/experiment/trial.py``, with its own atomic
JSON write (``atomic_write_json``) in place of ray_tpu's
``_private/atomic_io``, which the controller and the tracker callbacks
use too.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"

_VALID = {
    PENDING: {RUNNING, TERMINATED, ERROR},
    RUNNING: {PAUSED, TERMINATED, ERROR, PENDING},
    PAUSED: {RUNNING, TERMINATED, ERROR},
    TERMINATED: set(),
    ERROR: {PENDING},  # retry resets to PENDING
}


def atomic_write_json(path: str, obj: Any, **dump_kwargs: Any) -> None:
    """Writes ``obj`` as JSON to ``path`` through a temp file and
    ``os.replace``: a reader sees the old content or the new, never a torn
    file. A ``TypeError`` from ``json.dumps`` leaves nothing behind."""
    data = json.dumps(obj, **dump_kwargs).encode()
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:  # already renamed, or never created
            pass
        raise


class Trial:
    def __init__(
        self,
        trainable_name: str,
        config: dict,
        trial_id: str | None = None,
        experiment_dir: str = "",
        stopping_criteria: dict | None = None,
        max_failures: int = 0,
    ):
        self.trainable_name = trainable_name
        self.config = config
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.experiment_dir = experiment_dir
        self.stopping_criteria = dict(stopping_criteria or {})
        self.max_failures = max_failures

        self.status = PENDING
        self.last_result: dict = {}
        self.metric_history: list[dict] = []
        self.num_failures = 0
        self.error_message: str | None = None
        # Latest checkpoint as an opaque blob ref/path (controller-managed).
        self.checkpoint: Any = None
        self.checkpoint_iter: int = 0
        self.iteration = 0

    @property
    def local_dir(self) -> str:
        d = os.path.join(self.experiment_dir, f"{self.trainable_name}_{self.trial_id}")
        os.makedirs(d, exist_ok=True)
        return d

    def set_status(self, status: str) -> None:
        if status != self.status and status not in _VALID[self.status]:
            raise ValueError(f"invalid transition {self.status} → {status}")
        self.status = status

    def should_stop(self, result: dict) -> bool:
        return any(
            key in result and result[key] >= bound
            for key, bound in self.stopping_criteria.items()
        )

    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    # -- experiment-state (resume) serialization --

    def to_json(self) -> dict:
        return {
            "trainable_name": self.trainable_name,
            "config": self.config,
            "trial_id": self.trial_id,
            "status": TERMINATED if self.status == RUNNING else self.status,
            "last_result": self.last_result,
            "num_failures": self.num_failures,
            "error_message": self.error_message,
            "iteration": self.iteration,
            "checkpoint_iter": self.checkpoint_iter,
            "stopping_criteria": self.stopping_criteria,
            "max_failures": self.max_failures,
        }

    @classmethod
    def from_json(cls, data: dict, experiment_dir: str) -> "Trial":
        trial = cls(
            data["trainable_name"],
            data["config"],
            trial_id=data["trial_id"],
            experiment_dir=experiment_dir,
            stopping_criteria=data.get("stopping_criteria"),
            max_failures=data.get("max_failures", 0),
        )
        trial.status = data["status"]
        trial.last_result = data["last_result"]
        trial.num_failures = data["num_failures"]
        trial.error_message = data.get("error_message")
        trial.iteration = data.get("iteration", 0)
        trial.checkpoint_iter = data.get("checkpoint_iter", 0)
        ckpt_file = os.path.join(trial.local_dir, "checkpoint.json")
        if os.path.exists(ckpt_file):
            with open(ckpt_file) as f:
                trial.checkpoint = json.load(f).get("data")
        return trial

    def persist_checkpoint(self) -> None:
        """Durable copy for Tuner.restore (PBT exploits stay in-memory)."""
        if self.checkpoint is None:
            return
        try:
            atomic_write_json(
                os.path.join(self.local_dir, "checkpoint.json"),
                {"data": self.checkpoint, "iter": self.checkpoint_iter},
            )
        except TypeError:  # a checkpoint JSON cannot hold: a resume restarts fresh, by design
            pass

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, iter={self.iteration})"
