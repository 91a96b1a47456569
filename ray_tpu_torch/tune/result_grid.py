"""ResultGrid — what Tuner.fit() returns.

Role-equivalent of python/ray/tune/result_grid.py :: ResultGrid +
analysis/experiment_analysis.py best-trial selection.

Copied from ray_tpu's ``tune/result_grid.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch.tune.experiment.trial import ERROR, Trial


@dataclass
class TrialResult:
    trial_id: str
    config: dict
    metrics: dict
    error: Optional[str] = None
    checkpoint: Any = None
    path: str = ""
    metrics_history: list = field(default_factory=list)

    @property
    def metrics_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.metrics_history)


class ResultGrid:
    def __init__(self, trials: list[Trial], metric: str | None, mode: str | None):
        self._trials = trials
        self._metric = metric
        self._mode = mode
        self._results = [
            TrialResult(
                trial_id=t.trial_id,
                config=t.config,
                metrics=t.last_result,
                error=t.error_message if t.status == ERROR else None,
                checkpoint=t.checkpoint,
                path=t.local_dir,
                metrics_history=t.metric_history,
            )
            for t in trials
        ]

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, idx: int) -> TrialResult:
        return self._results[idx]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> list[str]:
        return [r.error for r in self._results if r.error]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    def get_best_result(
        self,
        metric: str | None = None,
        mode: str | None = None,
        scope: str = "last",
    ) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode or "max"
        if metric is None:
            raise ValueError("no metric given to get_best_result")
        sign = 1 if mode == "max" else -1

        def score(r: TrialResult) -> float:
            if scope == "all" and r.metrics_history:
                values = [
                    m[metric] for m in r.metrics_history if metric in m
                ]
                if values:
                    return sign * max(sign * v for v in values)
            if metric in r.metrics:
                return sign * r.metrics[metric]
            return float("-inf")

        candidates = [r for r in self._results if not r.error]
        if not candidates:
            raise RuntimeError("all trials errored")
        return max(candidates, key=score)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = dict(r.metrics)
            row["trial_id"] = r.trial_id
            for key, value in r.config.items():
                row[f"config/{key}"] = value
            rows.append(row)
        return pd.DataFrame(rows)
