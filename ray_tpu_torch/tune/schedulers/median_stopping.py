"""Median stopping rule.

Role-equivalent of python/ray/tune/schedulers/median_stopping_rule.py ::
MedianStoppingRule — stop a trial at time t if its best result so far is
worse than the median of other trials' running averages at t.

Copied from ray_tpu's ``tune/schedulers/median_stopping.py``.
"""

from __future__ import annotations

import statistics

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class MedianStoppingRule(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str | None = None,
        mode: str | None = None,
        grace_period: float = 1.0,
        min_samples_required: int = 3,
        min_time_slice: float = 0.0,
        hard_stop: bool = True,
    ):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.grace_period = grace_period
        self.min_samples_required = min_samples_required
        self.min_time_slice = min_time_slice
        self.hard_stop = hard_stop
        # trial_id -> list[(t, signed value)]
        self._results: dict[str, list[tuple[float, float]]] = {}
        self._num_stopped = 0

    def _signed(self, result: dict) -> float:
        value = result[self.metric]
        return value if self.mode == "max" else -value

    def _running_mean_at(self, trial_id: str, t: float) -> float | None:
        points = [v for (pt, v) in self._results.get(trial_id, []) if pt <= t]
        return statistics.fmean(points) if points else None

    def on_trial_result(self, controller, trial, result: dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return self.CONTINUE
        t = result[self.time_attr]
        self._results.setdefault(trial.trial_id, []).append(
            (t, self._signed(result))
        )
        if t < self.grace_period:
            return self.CONTINUE
        other_means = [
            m
            for other_id in self._results
            if other_id != trial.trial_id
            and (m := self._running_mean_at(other_id, t)) is not None
        ]
        if len(other_means) < self.min_samples_required:
            return self.CONTINUE
        median = statistics.median(other_means)
        best = max(v for _, v in self._results[trial.trial_id])
        if best < median:
            self._num_stopped += 1
            return self.STOP if self.hard_stop else self.PAUSE
        return self.CONTINUE

    def debug_string(self) -> str:
        return f"MedianStoppingRule: {self._num_stopped} stopped"
