"""OptunaSearch — adapter to the Optuna TPE sampler.

Role-equivalent of python/ray/tune/search/optuna/optuna_search.py ::
OptunaSearch. Gated on `import optuna` (not baked into this image); the
adapter maps ray_tpu_torch.tune.search.sample Domains onto an optuna
distribution per suggest() call, and feeds completed results back as
optuna trials — same translation the reference performs.

Copied from ray_tpu's ``tune/search/optuna.py``, with the same import
guard.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.tune.search.sample import Categorical, Domain, Float, Integer, Quantized
from ray_tpu_torch.tune.search.searcher import Searcher

try:
    import optuna as _optuna
except ImportError:  # pragma: no cover - optional dependency
    _optuna = None


class OptunaSearch(Searcher):
    def __init__(
        self,
        space: dict | None = None,
        metric: str | None = None,
        mode: str | None = None,
        sampler=None,
        seed: int | None = None,
    ):
        if _optuna is None:
            raise ImportError(
                "OptunaSearch requires `optuna`, which is not installed. "
                "Use BasicVariantGenerator or ASHAScheduler instead."
            )
        super().__init__(metric, mode)
        self._space = space or {}
        self._sampler = sampler or _optuna.samplers.TPESampler(seed=seed)
        self._study = _optuna.create_study(
            direction="maximize" if mode == "max" else "minimize",
            sampler=self._sampler,
        )
        self._ot_trials: dict[str, object] = {}

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        if config and not self._space:
            self._space = config
        return True

    def _suggest_param(self, ot_trial, name: str, domain) -> object:
        if isinstance(domain, Quantized):
            inner = domain.inner
            if isinstance(inner, Float):
                return ot_trial.suggest_float(
                    name, inner.lower, inner.upper, step=domain.q, log=inner.log
                )
        if isinstance(domain, Float):
            return ot_trial.suggest_float(
                name, domain.lower, domain.upper, log=domain.log
            )
        if isinstance(domain, Integer):
            return ot_trial.suggest_int(
                name, domain.lower, domain.upper - 1, log=domain.log
            )
        if isinstance(domain, Categorical):
            return ot_trial.suggest_categorical(name, domain.categories)
        return domain

    def suggest(self, trial_id: str) -> Optional[dict]:
        ot_trial = self._study.ask()
        self._ot_trials[trial_id] = ot_trial
        config = {}
        for name, domain in self._space.items():
            if isinstance(domain, Domain):
                config[name] = self._suggest_param(ot_trial, name, domain)
            else:
                config[name] = domain
        return config

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        ot_trial = self._ot_trials.pop(trial_id, None)
        if ot_trial is None:
            return
        if error or not result or self.metric not in result:
            self._study.tell(ot_trial, state=_optuna.trial.TrialState.FAIL)
        else:
            self._study.tell(ot_trial, result[self.metric])
