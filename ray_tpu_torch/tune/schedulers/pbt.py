"""Population Based Training.

Role-equivalent of python/ray/tune/schedulers/pbt.py ::
PopulationBasedTraining. At every `perturbation_interval` along each trial's
time axis: bottom-quantile trials EXPLOIT a top-quantile trial (copy its
checkpoint + config) then EXPLORE (mutate hyperparameters by 1.2/0.8
perturbation or resample).

Copied from ray_tpu's ``tune/schedulers/pbt.py``. The checkpoint moves
between the trials' processes through the controller, as pickled bytes
(``execution/tune_controller.py``), where the reference's rides the
object store.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Mapping

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler
from ray_tpu_torch.tune.search.sample import Domain


class PopulationBasedTraining(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str | None = None,
        mode: str | None = None,
        perturbation_interval: float = 10.0,
        hyperparam_mutations: Mapping[str, Any] | None = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        perturbation_factors: tuple[float, float] = (1.2, 0.8),
        custom_explore_fn: Callable[[dict], dict] | None = None,
        seed: int | None = None,
    ):
        if not hyperparam_mutations and custom_explore_fn is None:
            raise ValueError(
                "PBT needs hyperparam_mutations and/or custom_explore_fn"
            )
        if not 0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.perturbation_interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations or {})
        self.quantile_fraction = quantile_fraction
        self.resample_probability = resample_probability
        self.perturbation_factors = perturbation_factors
        self.custom_explore_fn = custom_explore_fn
        self._rng = random.Random(seed)
        self._last_perturb: dict[str, float] = {}
        self._scores: dict[str, float] = {}
        self.num_perturbations = 0

    def _signed(self, result: dict) -> float:
        value = result[self.metric]
        return value if self.mode == "max" else -value

    def _quantiles(self, controller) -> tuple[list, list]:
        """(bottom, top) trials by latest score; only trials that reported."""
        scored = [
            t for t in controller.live_trials if t.trial_id in self._scores
        ]
        scored.sort(key=lambda t: self._scores[t.trial_id])
        if len(scored) <= 1:
            return [], []
        k = max(1, int(len(scored) * self.quantile_fraction))
        if 2 * k > len(scored):
            k = len(scored) // 2
        return scored[:k], scored[-k:]

    def explore(self, config: dict) -> dict:
        new = dict(config)
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_probability or key not in new:
                if isinstance(spec, Domain):
                    new[key] = spec.sample(self._rng)
                elif isinstance(spec, (list, tuple)):
                    new[key] = self._rng.choice(list(spec))
                elif callable(spec):
                    new[key] = spec()
            elif isinstance(new[key], (int, float)) and not isinstance(new[key], bool):
                factor = self._rng.choice(self.perturbation_factors)
                mutated = new[key] * factor
                new[key] = type(new[key])(mutated) if isinstance(new[key], int) else mutated
            elif isinstance(spec, (list, tuple)):
                # Non-numeric: step to a neighbouring listed value.
                values = list(spec)
                if new[key] in values:
                    idx = values.index(new[key])
                    shift = self._rng.choice((-1, 1))
                    new[key] = values[max(0, min(len(values) - 1, idx + shift))]
        if self.custom_explore_fn:
            new = self.custom_explore_fn(new)
        return new

    def on_trial_add(self, controller, trial) -> None:
        self._last_perturb[trial.trial_id] = 0.0

    def on_trial_result(self, controller, trial, result: dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return self.CONTINUE
        self._scores[trial.trial_id] = self._signed(result)
        t = result[self.time_attr]
        if t - self._last_perturb.get(trial.trial_id, 0) < self.perturbation_interval:
            return self.CONTINUE
        self._last_perturb[trial.trial_id] = t
        bottom, top = self._quantiles(controller)
        if trial in bottom and top:
            donor = self._rng.choice(top)
            self._exploit(controller, trial, donor)
        return self.CONTINUE

    def _exploit(self, controller, trial, donor) -> None:
        """Copy donor's checkpoint + explored config into `trial`."""
        self.num_perturbations += 1
        new_config = self.explore(donor.config)
        controller.transplant_trial(trial, donor, new_config)

    def on_trial_complete(self, controller, trial, result: dict) -> None:
        self._scores.pop(trial.trial_id, None)

    def debug_string(self) -> str:
        return f"PBT: {self.num_perturbations} perturbations"
