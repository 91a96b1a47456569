"""Trial scheduler protocol.

Role-equivalent of python/ray/tune/schedulers/trial_scheduler.py ::
TrialScheduler / FIFOScheduler. Schedulers see every intermediate result and
decide CONTINUE / PAUSE / STOP; the controller enforces the decision.

Copied from ray_tpu's ``tune/schedulers/trial_scheduler.py``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.tune.experiment.trial import Trial


class TrialScheduler:
    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"

    metric: str | None = None
    mode: str | None = None

    def set_search_properties(self, metric: str | None, mode: str | None) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def on_trial_add(self, controller, trial: "Trial") -> None:
        pass

    def on_trial_result(self, controller, trial: "Trial", result: dict) -> str:
        return self.CONTINUE

    def on_trial_complete(self, controller, trial: "Trial", result: dict) -> None:
        pass

    def on_trial_error(self, controller, trial: "Trial") -> None:
        pass

    def choose_trial_to_run(self, controller) -> "Trial | None":
        """Pick the next PENDING/PAUSED trial to (re)start, or None."""
        for trial in controller.live_trials:
            if trial.status == "PENDING":
                return trial
        for trial in controller.live_trials:
            if trial.status == "PAUSED":
                return trial
        return None

    def debug_string(self) -> str:
        return type(self).__name__


class FIFOScheduler(TrialScheduler):
    """Run trials to completion in submission order."""
