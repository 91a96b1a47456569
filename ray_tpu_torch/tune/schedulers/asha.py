"""Asynchronous Successive Halving (ASHA) + synchronous HyperBand.

Role-equivalents of python/ray/tune/schedulers/async_hyperband.py ::
AsyncHyperBandScheduler (alias ASHAScheduler) and hyperband.py ::
HyperBandScheduler. The rung math here is pure (no actors) so it is
table-testable exactly like the reference's test_trial_scheduler.py drives
it with fabricated results (SURVEY §4.3).

Copied from ray_tpu's ``tune/schedulers/asha.py``: one result stream
gives the same decisions in both packages.
"""

from __future__ import annotations

import math

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class _Bracket:
    """One ASHA bracket: rungs at r, r·η, r·η², … ≤ max_t. A trial stops at
    a rung unless its metric is in the top 1/η of recorded values there."""

    def __init__(self, min_t: float, max_t: float, reduction_factor: float, s: int):
        self.rf = reduction_factor
        self._rungs: list[tuple[float, dict]] = [
            (min_t * self.rf ** (k + s), {})
            for k in reversed(range(int(math.log(max_t / min_t) / math.log(self.rf) - s + 1)))
        ]

    def cutoff(self, recorded: dict) -> float | None:
        if not recorded:
            return None
        values = sorted(recorded.values())
        k = int(len(values) * (1 - 1 / self.rf))
        return values[min(k, len(values) - 1)]

    def on_result(self, trial_id: str, cur_t: float, metric_value: float) -> str:
        action = TrialScheduler.CONTINUE
        for milestone, recorded in self._rungs:
            if cur_t < milestone or trial_id in recorded:
                continue
            cutoff = self.cutoff(recorded)
            if cutoff is not None and metric_value < cutoff:
                action = TrialScheduler.STOP
            recorded[trial_id] = metric_value
            break
        return action

    def debug_string(self) -> str:
        rungs = ", ".join(
            f"t={m:.0f}:{len(r)}" for m, r in self._rungs
        )
        return f"Bracket({rungs})"


class ASHAScheduler(TrialScheduler):
    """Async successive halving: aggressive early stopping without waiting
    for rungs to fill. The default Tune scheduler for sweeps."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str | None = None,
        mode: str | None = None,
        max_t: float = 100,
        grace_period: float = 1,
        reduction_factor: float = 4,
        brackets: int = 1,
    ):
        if grace_period < 1:
            raise ValueError("grace_period must be >= 1")
        if reduction_factor <= 1:
            raise ValueError("reduction_factor must be > 1")
        if max_t < grace_period:
            raise ValueError("max_t must be >= grace_period")
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.max_t = max_t
        self._brackets = [
            _Bracket(grace_period, max_t, reduction_factor, s)
            for s in range(brackets)
        ]
        self._trial_bracket: dict[str, _Bracket] = {}
        self._counter = 0
        self._num_stopped = 0

    def _signed(self, result: dict) -> float:
        value = result[self.metric]
        return value if self.mode == "max" else -value

    def on_trial_add(self, controller, trial) -> None:
        # Round-robin over brackets (reference uses softmax over sizes;
        # round-robin gives the same asymptotic occupancy deterministically).
        bracket = self._brackets[self._counter % len(self._brackets)]
        self._counter += 1
        self._trial_bracket[trial.trial_id] = bracket

    def on_trial_result(self, controller, trial, result: dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return self.CONTINUE
        cur_t = result[self.time_attr]
        if cur_t >= self.max_t:
            return self.STOP
        action = self._trial_bracket[trial.trial_id].on_result(
            trial.trial_id, cur_t, self._signed(result)
        )
        if action == self.STOP:
            self._num_stopped += 1
        return action

    def on_trial_complete(self, controller, trial, result: dict) -> None:
        if self.metric not in result or self.time_attr not in result:
            return
        self._trial_bracket[trial.trial_id].on_result(
            trial.trial_id, result[self.time_attr], self._signed(result)
        )

    def debug_string(self) -> str:
        lines = [f"ASHA: {self._num_stopped} stopped early"]
        lines += [b.debug_string() for b in self._brackets]
        return "\n".join(lines)


# Reference alias
AsyncHyperBandScheduler = ASHAScheduler


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand: ASHA brackets but halving waits for the rung
    to fill. Implemented on the same rung table; "synchronous" here means a
    rung only evicts once it holds `reduction_factor` entries, which the
    cutoff math already guarantees (cutoff is None below that)."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str | None = None,
        mode: str | None = None,
        max_t: float = 81,
        reduction_factor: float = 3,
    ):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.max_t = max_t
        s_max = int(math.log(max_t) / math.log(reduction_factor))
        self._inner = ASHAScheduler(
            time_attr=time_attr,
            metric=metric,
            mode=mode,
            max_t=max_t,
            grace_period=1,
            reduction_factor=reduction_factor,
            brackets=s_max + 1,
        )

    def set_search_properties(self, metric, mode) -> bool:
        self._inner.set_search_properties(metric, mode)
        return super().set_search_properties(metric, mode)

    def on_trial_add(self, controller, trial) -> None:
        self._inner.on_trial_add(controller, trial)

    def on_trial_result(self, controller, trial, result: dict) -> str:
        return self._inner.on_trial_result(controller, trial, result)

    def on_trial_complete(self, controller, trial, result: dict) -> None:
        self._inner.on_trial_complete(controller, trial, result)
