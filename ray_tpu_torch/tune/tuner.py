"""Tuner — the experiment entry point.

Role-equivalent of python/ray/tune/tuner.py :: Tuner (+ impl/tuner_internal
and tune.py :: run). Accepts a function trainable, a Trainable subclass, or
a ray_tpu_torch.train trainer instance (which is wrapped so param_space's
`train_loop_config` merges into the trainer — the reference's
Tuner(trainer) path, SURVEY §3.3).

Port of ray_tpu's ``tune/tuner.py``, on the port's ``RunConfig`` and
``TorchTrainer``. The trainer wrapper is a module-level callable class
(``_TrainerTrainable``, the reference's ``_wrap_trainer`` closure) that
holds the trainer, so that stdlib pickle takes both to the trial's
process; the trainer's gang is spawned there, from the function
trainable's thread. The reference's runtime telemetry
(``usage.record_feature``) has no counterpart.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Any

from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.tune.execution.tune_controller import TuneController
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers.trial_scheduler import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.search.searcher import ConcurrencyLimiter, Searcher
from ray_tpu_torch.tune.trainable import Trainable, _WithResources, report, wrap_function


@dataclass
class TuneConfig:
    """Mirrors ray.tune.TuneConfig."""

    metric: str | None = None
    mode: str | None = None
    search_alg: Searcher | None = None
    scheduler: TrialScheduler | None = None
    num_samples: int = 1
    max_concurrent_trials: int | None = None
    time_budget_s: float | None = None
    reuse_actors: bool = False
    seed: int | None = None


def _is_trainer(obj: Any) -> bool:
    return hasattr(obj, "fit") and hasattr(obj, "train_loop_config")


class _ForwardToTune:
    """A trainer trial's RunConfig callback: each round's metrics to
    ``tune.report``."""

    def on_result(self, metrics: dict) -> None:
        report(metrics)


class _TrainerTrainable:
    """Runs a copy of the trainer inside the trial, forwarding per-round
    metrics to tune.report via a RunConfig callback. Stdlib pickle takes
    it, and the trainer it holds, to the trial's actor."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.__name__ = type(trainer).__name__

    def __call__(self, config: dict) -> None:
        local = copy.copy(self.trainer)
        local.train_loop_config = {
            **self.trainer.train_loop_config,
            **config.get("train_loop_config", {}),
        }
        for key, value in config.items():
            if key != "train_loop_config" and hasattr(local, key):
                setattr(local, key, value)
        local.run_config = copy.copy(local.run_config or RunConfig())
        local.run_config.callbacks = list(local.run_config.callbacks) + [_ForwardToTune()]
        result = local.fit()
        if result.error is not None:
            raise result.error


class Tuner:
    def __init__(
        self,
        trainable: Any,
        *,
        param_space: dict | None = None,
        tune_config: TuneConfig | None = None,
        run_config: RunConfig | None = None,
        _restore_path: str | None = None,
        _resume_errored: bool = False,
    ):
        self.param_space = dict(param_space or {})
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_path = _restore_path
        self._resume_errored = _resume_errored
        # What each trial's actor leases (``tune.with_resources``).
        self._resources = getattr(trainable, "resources", None) if isinstance(
            trainable, _WithResources) else None

        if isinstance(trainable, type) and issubclass(trainable, Trainable):
            self._trainable_cls = trainable
            self._name = trainable.__name__
        elif _is_trainer(trainable):
            fn = _TrainerTrainable(trainable)
            self._trainable_cls = wrap_function(fn)
            self._name = fn.__name__
        elif callable(trainable):
            self._trainable_cls = wrap_function(trainable)
            self._name = getattr(trainable, "__name__", "trainable")
        else:
            raise TypeError(f"cannot tune {trainable!r}")

    @classmethod
    def restore(
        cls,
        path: str,
        trainable: Any,
        *,
        param_space: dict | None = None,
        resume_errored: bool = False,
    ) -> "Tuner":
        """Rebuild a Tuner from an experiment dir written by a prior fit()."""
        run_config = RunConfig(
            name=os.path.basename(path.rstrip("/")),
            storage_path=os.path.dirname(path.rstrip("/")),
        )
        return cls(
            trainable,
            param_space=param_space,
            run_config=run_config,
            _restore_path=path,
            _resume_errored=resume_errored,
        )

    @classmethod
    def can_restore(cls, path: str) -> bool:
        return os.path.exists(os.path.join(path, "experiment_state.json"))

    def _experiment_dir(self) -> str:
        name = self.run_config.name or f"{self._name}_experiment"
        return os.path.join(self.run_config.resolved_storage_path(), name)

    def fit(self) -> ResultGrid:
        cfg = self.tune_config
        searcher = cfg.search_alg or BasicVariantGenerator(
            self.param_space,
            num_samples=cfg.num_samples,
            random_state=cfg.seed,
        )
        if cfg.max_concurrent_trials and not isinstance(
            searcher, ConcurrencyLimiter
        ):
            searcher = ConcurrencyLimiter(searcher, cfg.max_concurrent_trials)
        searcher.set_search_properties(cfg.metric, cfg.mode, self.param_space)

        num_samples_cap = None
        # The variant count of a generator under a ConcurrencyLimiter too:
        # the reference caps that case at num_samples, so that
        # max_concurrent_trials cuts a grid short (ROADMAP Queue C item 14).
        inner = searcher.searcher if isinstance(searcher, ConcurrencyLimiter) else searcher
        if isinstance(inner, BasicVariantGenerator):
            num_samples_cap = inner.total_samples
        elif cfg.num_samples > 0:
            num_samples_cap = cfg.num_samples

        controller = TuneController(
            self._trainable_cls,
            searcher=searcher,
            scheduler=cfg.scheduler or FIFOScheduler(),
            metric=cfg.metric,
            mode=cfg.mode,
            num_samples_cap=num_samples_cap,
            max_concurrent_trials=cfg.max_concurrent_trials,
            experiment_dir=self._experiment_dir(),
            stopping_criteria=dict(self.run_config.stop or {}),
            max_failures=self.run_config.failure_config.max_failures,
            checkpoint_freq=self.run_config.checkpoint_config.checkpoint_frequency,
            callbacks=self.run_config.callbacks,
            time_budget_s=cfg.time_budget_s,
            resources_per_trial=self._resources,
        )
        if self._restore_path:
            controller.restore_experiment_state(self._resume_errored)
        trials = controller.run()
        return ResultGrid(trials, cfg.metric, cfg.mode)


def run(
    trainable: Any,
    *,
    config: dict | None = None,
    metric: str | None = None,
    mode: str | None = None,
    num_samples: int = 1,
    scheduler: TrialScheduler | None = None,
    search_alg: Searcher | None = None,
    stop: dict | None = None,
    storage_path: str | None = None,
    name: str | None = None,
    max_concurrent_trials: int | None = None,
    time_budget_s: float | None = None,
) -> ResultGrid:
    """ray.tune.run-equivalent convenience wrapper over Tuner."""
    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric,
            mode=mode,
            num_samples=num_samples,
            scheduler=scheduler,
            search_alg=search_alg,
            max_concurrent_trials=max_concurrent_trials,
            time_budget_s=time_budget_s,
        ),
        run_config=RunConfig(name=name, storage_path=storage_path, stop=stop),
    )
    return tuner.fit()
