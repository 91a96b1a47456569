"""TuneController — THE trial event loop.

Role-equivalent of python/ray/tune/execution/tune_controller.py ::
TuneController (SURVEY §2.5, §3.3): asks the searcher for configs, launches
trials, consumes intermediate results, consults the scheduler
(CONTINUE/PAUSE/STOP), persists experiment state for resume, restarts failed
trials from their last checkpoint, and supports PBT checkpoint transplants.

Port of ray_tpu's ``tune/execution/tune_controller.py``. Each trial is a
runtime actor, the reference's ``_TrialActor``, so ``Tuner.fit()`` needs
``ray_tpu_torch.init()`` first:

* Resources. A trial's actor is started with ``num_cpus``, ``num_gpus``
  and ``resources`` from ``resources_per_trial`` (every key, as the
  reference hands every key to its runtime), and leases them from the node
  agent; a trial asking for ``GPU`` sees only its lease's cards. A trial
  that does not fit waits, PENDING in the runtime, until one that runs
  frees its resources; one asking for a key the cluster never declared
  waits as the reference's infeasible actor does.
* Interface. The actor answers ``train`` / ``save`` / ``restore`` /
  ``reset`` / ``stop`` with the reference's timeouts (``CALL_TIMEOUT_S``,
  ``RESTORE_TIMEOUT_S``, ``STOP_TIMEOUT_S``); results are awaited with
  ``ray_tpu_torch.wait`` and ``get``. A stopped trial is asked to
  ``stop`` (a function trainable's waits for its thread, and so for a
  ``TorchTrainer``'s gang to shut down) and then killed.
* Nesting. A trainer trial's actor forms its gang, a placement group and
  its member actors, from inside its worker, as in the reference.
* Pickling the trainable. User code goes by module and qualified name
  (``TrainableRef``, as serve's ``CallableRef`` sends deployments), never
  by value, and a function is wrapped (``wrap_function``) inside the
  trial's actor; a callable instance (the Tuner's trainer wrapper,
  ``with_parameters``) goes as stdlib pickle, its class and the functions
  it holds again by name (``_private.code_ref``). A trainable defined under
  ``<locals>`` raises ``ValueError``.
* Concurrency. The cluster's CPUs (``ray_tpu_torch.cluster_resources()``)
  over the trial's CPUs, as the reference divides them;
  ``max_concurrent_trials`` overrides it.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import sys
import time
import traceback
import types
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch._private import code_ref
from ray_tpu_torch.tune.experiment.trial import (
    ERROR, PAUSED, PENDING, RUNNING, TERMINATED, Trial, atomic_write_json,
)
from ray_tpu_torch.tune.schedulers.trial_scheduler import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.trainable import wrap_function

EXPERIMENT_STATE_FILE = "experiment_state.json"

# The reference's timeouts: a result, save, reset or a transplant's restore
# (60 s), the restore that starts a trial (120 s, which includes the actor's
# start), and stop (5 s) before the kill.
CALL_TIMEOUT_S = 60.0
RESTORE_TIMEOUT_S = 120.0
STOP_TIMEOUT_S = 5.0

logger = logging.getLogger(__name__)


class TrainableRef:
    """A trainable on its way to a trial's actor. A function or a
    ``Trainable`` subclass goes by module and qualified name and is
    imported there; a function trainable is wrapped there. A callable
    instance goes as stdlib pickle bytes, what it holds by name."""

    def __init__(self, trainable_cls: type):
        fn = getattr(trainable_cls, "_train_fn", None)
        self.wrap = fn is not None
        target = fn if self.wrap else trainable_cls
        self.name = self.payload = None
        if isinstance(target, (type, types.FunctionType)):
            self.name = code_ref.name_of(target)
            found = sys.modules.get(target.__module__)
            for part in target.__qualname__.split("."):
                found = getattr(found, part, None)
            if found is not target:
                raise ValueError(
                    f"{self.name[0]}.{self.name[1]} is not reachable by its name: a trainable "
                    f"must be defined at the top level of an importable module (each trial's "
                    f"actor imports it by name)")
        else:
            try:
                self.payload = code_ref.dumps(target)
            except (pickle.PicklingError, AttributeError, TypeError, ValueError) as exc:
                raise ValueError(
                    f"{target!r} does not pickle: a callable trainable's class, and the "
                    f"functions and objects it holds, must be defined at the top level of an "
                    f"importable module (each trial's actor imports them by name): {exc}"
                ) from exc

    def resolve(self) -> type:
        """The Trainable class, in the trial's actor."""
        if self.payload is not None:
            target = code_ref.loads(self.payload)
        else:
            target = code_ref.lookup(*self.name)
        return wrap_function(target) if self.wrap else target


class _TrialActor:
    """Hosts one Trainable instance; its remote surface mirrors the
    reference's trainable-actor protocol (train/save/restore/reset/stop).
    A trainable whose construction raised answers every call with that
    error (the runtime would otherwise retry the actor's start until its
    placement deadline)."""

    def __init__(self, ref: TrainableRef, config: dict):
        self._trainable, self._failed = None, None
        try:
            self._trainable = ref.resolve()(config)
        except Exception:
            self._failed = traceback.format_exc()

    def _get(self):
        if self._failed is not None:
            raise RuntimeError(f"the trainable failed to start:\n{self._failed}")
        return self._trainable

    def train(self) -> dict:
        return self._get().train()

    def save(self) -> Any:
        return self._get().save()

    def restore(self, checkpoint: Any) -> str:
        self._get().restore(checkpoint)
        return "ok"

    def reset(self, new_config: dict) -> bool:
        return self._get().reset(new_config)

    def stop(self) -> str:
        self._get().stop()
        return "ok"

    def pid(self) -> int:
        return os.getpid()


class TuneController:
    def __init__(
        self,
        trainable_cls: type,
        *,
        searcher: Searcher,
        scheduler: TrialScheduler | None = None,
        metric: str | None = None,
        mode: str | None = None,
        num_samples_cap: int | None = None,
        max_concurrent_trials: int | None = None,
        experiment_dir: str = "",
        stopping_criteria: dict | None = None,
        max_failures: int = 0,
        checkpoint_freq: int = 0,
        resources_per_trial: dict | None = None,
        callbacks: list | None = None,
        time_budget_s: float | None = None,
    ):
        self.trainable_cls = trainable_cls
        self.trainable_name = getattr(trainable_cls, "__name__", "trainable")
        self._ref = TrainableRef(trainable_cls)
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.metric, self.mode = metric, mode
        self.scheduler.set_search_properties(metric, mode)
        self.searcher.set_search_properties(metric, mode, {})
        self.num_samples_cap = num_samples_cap
        self.experiment_dir = experiment_dir
        os.makedirs(experiment_dir, exist_ok=True)
        self.stopping_criteria = dict(stopping_criteria or {})
        self.max_failures = max_failures
        self.checkpoint_freq = checkpoint_freq
        self.resources_per_trial = dict(resources_per_trial or {"CPU": 1})
        self.callbacks = list(callbacks or [])
        self.time_budget_s = time_budget_s

        self.trials: list[Trial] = []
        self._actors: dict[str, Any] = {}  # trial_id -> ActorHandle
        self._futures: dict[Any, Trial] = {}  # train() ObjectRef -> Trial
        self._searcher_exhausted = False
        if max_concurrent_trials:
            self._max_concurrent = max_concurrent_trials
        else:
            cpus = ray_tpu_torch.cluster_resources().get("CPU", 4)
            per_trial = max(self.resources_per_trial.get("CPU", 1), 0.01)
            self._max_concurrent = max(1, int(cpus / per_trial))

    # -- scheduler hooks --

    @property
    def live_trials(self) -> list[Trial]:
        return [t for t in self.trials if not t.is_finished()]

    def transplant_trial(self, trial: Trial, donor: Trial, new_config: dict) -> None:
        """PBT exploit: copy donor's latest checkpoint + new config into
        trial's actor (reset in place or recreate)."""
        donor_actor = self._actors.get(donor.trial_id)
        if donor_actor is not None:
            try:
                donor.checkpoint = ray_tpu_torch.get(donor_actor.save.remote(),
                                                     timeout=CALL_TIMEOUT_S)
                donor.checkpoint_iter = donor.iteration
            except Exception:
                # Exploit proceeds from the donor's LAST saved checkpoint.
                logger.warning(
                    "transplant: saving donor %s failed; using its last "
                    "checkpoint (iter %s)",
                    donor.trial_id, donor.checkpoint_iter, exc_info=True,
                )
        trial.config = dict(new_config)
        trial.checkpoint = donor.checkpoint
        trial.checkpoint_iter = donor.checkpoint_iter
        actor = self._actors.get(trial.trial_id)
        if actor is None:
            return
        try:
            in_place = ray_tpu_torch.get(actor.reset.remote(new_config), timeout=CALL_TIMEOUT_S)
        except Exception:
            in_place = False
        if not in_place:
            self._drop_pending_future(trial)
            self._kill_actor(trial)
            self._start_trial_actor(trial)
        elif trial.checkpoint is not None:
            ray_tpu_torch.get(actor.restore.remote(trial.checkpoint), timeout=CALL_TIMEOUT_S)

    # -- lifecycle --

    def _next_trial(self) -> Optional[Trial]:
        if self._searcher_exhausted:
            return None
        if self.num_samples_cap is not None and len(self.trials) >= self.num_samples_cap:
            return None
        trial_id = f"{len(self.trials):05d}"
        config = self.searcher.suggest(trial_id)
        if config is None:
            if not isinstance(self.searcher, Searcher) or not getattr(
                self.searcher, "max_concurrent", 0
            ):
                self._searcher_exhausted = (
                    len(self._live_suggestions()) == 0
                )
            return None
        trial = Trial(
            self.trainable_name,
            config,
            trial_id=trial_id,
            experiment_dir=self.experiment_dir,
            stopping_criteria=self.stopping_criteria,
            max_failures=self.max_failures,
        )
        self.trials.append(trial)
        self.scheduler.on_trial_add(self, trial)
        for cb in self.callbacks:
            self._fire(cb, "on_trial_add", trial=trial)
        return trial

    def _live_suggestions(self) -> list[Trial]:
        return [t for t in self.trials if t.status in (PENDING, RUNNING, PAUSED)]

    def _start_trial_actor(self, trial: Trial) -> None:
        rpt = dict(self.resources_per_trial)
        cpus, gpus = rpt.pop("CPU", 1), rpt.pop("GPU", 0)
        actor = ray_tpu_torch.remote(_TrialActor).options(
            num_cpus=cpus, num_gpus=gpus, resources=rpt or None,
        ).remote(self._ref, trial.config)
        self._actors[trial.trial_id] = actor
        if trial.checkpoint is not None:
            ray_tpu_torch.get(actor.restore.remote(trial.checkpoint), timeout=RESTORE_TIMEOUT_S)
        trial.set_status(RUNNING)
        self._futures[actor.train.remote()] = trial

    def _kill_actor(self, trial: Trial) -> None:
        actor = self._actors.pop(trial.trial_id, None)
        if actor is None:
            return
        try:
            ray_tpu_torch.get(actor.stop.remote(), timeout=STOP_TIMEOUT_S)
        except Exception:  # stop timed out or the actor is gone; the kill follows
            pass
        try:
            ray_tpu_torch.kill(actor)
        except exceptions.RayTpuError:
            pass  # the actor is already gone

    def _drop_pending_future(self, trial: Trial) -> None:
        for ref, t in list(self._futures.items()):
            if t is trial:
                del self._futures[ref]

    def _running_count(self) -> int:
        return sum(1 for t in self.trials if t.status == RUNNING)

    # -- the event loop --

    def step(self) -> None:
        # 1. top up trials from the searcher
        while self._running_count() < self._max_concurrent:
            pending = [t for t in self.trials if t.status == PENDING]
            if not pending:
                created = self._next_trial()
                if created is None:
                    break
            choice = self.scheduler.choose_trial_to_run(self)
            if choice is None:
                break
            self._start_trial_actor(choice)

        if not self._futures:
            return

        # 2. consume one completed train() (the reference's num_returns=1)
        ready, _ = ray_tpu_torch.wait(list(self._futures), num_returns=1, timeout=1.0)
        for ref in ready:
            trial = self._futures.pop(ref)
            try:
                result = ray_tpu_torch.get(ref, timeout=CALL_TIMEOUT_S)
            except Exception as exc:
                self._handle_trial_error(trial, exc)
                continue
            self._handle_result(trial, result)

    def _handle_result(self, trial: Trial, result: dict) -> None:
        trial.iteration = result.get("training_iteration", trial.iteration + 1)
        if "__checkpoint__" in result:
            trial.checkpoint = result.pop("__checkpoint__")
            trial.checkpoint_iter = trial.iteration
            trial.persist_checkpoint()
        # Merge over previous metrics: the function-API's final sentinel
        # ({done: True} with only bookkeeping keys) must not erase the last
        # real report — the reference attaches done to the last result too.
        bookkeeping = {"done", "training_iteration", "time_total_s"}
        trial.last_result = {**trial.last_result, **result}
        if set(result) - bookkeeping:
            trial.metric_history.append(result)
        self.searcher.on_trial_result(trial.trial_id, result)
        for cb in self.callbacks:
            self._fire(cb, "on_trial_result", trial=trial, result=result)

        done = bool(result.get("done")) or trial.should_stop(result)
        decision = TrialScheduler.CONTINUE
        if not done:
            decision = self.scheduler.on_trial_result(self, trial, result)

        checkpoint_now = (
            self.checkpoint_freq
            and trial.iteration - trial.checkpoint_iter >= self.checkpoint_freq
        )
        if (checkpoint_now or done or decision != TrialScheduler.CONTINUE) and (
            actor := self._actors.get(trial.trial_id)
        ):
            try:
                ckpt = ray_tpu_torch.get(actor.save.remote(), timeout=CALL_TIMEOUT_S)
                if ckpt is not None:
                    trial.checkpoint = ckpt
                    trial.checkpoint_iter = trial.iteration
                    trial.persist_checkpoint()
            except Exception:
                # A missed save costs resume granularity, not correctness —
                # but a silently failing one costs the whole experiment.
                logger.warning(
                    "checkpointing trial %s failed", trial.trial_id,
                    exc_info=True,
                )

        if done:
            self._complete_trial(trial, result)
        elif decision == TrialScheduler.STOP:
            self._complete_trial(trial, result, early_stopped=True)
        elif decision == TrialScheduler.PAUSE:
            trial.set_status(PAUSED)
            self._kill_actor(trial)
        else:
            actor = self._actors.get(trial.trial_id)
            if actor is not None:
                self._futures[actor.train.remote()] = trial
        self._save_experiment_state()

    def _complete_trial(
        self, trial: Trial, result: dict, early_stopped: bool = False
    ) -> None:
        trial.set_status(TERMINATED)
        self._drop_pending_future(trial)
        self._kill_actor(trial)
        self.searcher.on_trial_complete(trial.trial_id, result)
        self.scheduler.on_trial_complete(self, trial, result)
        for cb in self.callbacks:
            self._fire(cb, "on_trial_complete", trial=trial, result=result)

    def _handle_trial_error(self, trial: Trial, exc: Exception) -> None:
        trial.num_failures += 1
        trial.error_message = "".join(
            traceback.format_exception_only(type(exc), exc)
        ).strip()
        self._drop_pending_future(trial)
        self._kill_actor(trial)
        if trial.num_failures <= trial.max_failures:
            trial.set_status(ERROR)
            trial.set_status(PENDING)  # retry (restores from checkpoint)
        else:
            trial.set_status(ERROR)
            self.searcher.on_trial_complete(trial.trial_id, error=True)
            self.scheduler.on_trial_error(self, trial)
            for cb in self.callbacks:
                self._fire(cb, "on_trial_error", trial=trial)
        self._save_experiment_state()

    def run(self) -> list[Trial]:
        start = time.time()
        try:
            while True:
                self.step()
                if self.time_budget_s and time.time() - start > self.time_budget_s:
                    for trial in self.live_trials:
                        self._drop_pending_future(trial)
                        self._kill_actor(trial)
                        trial.set_status(TERMINATED)
                    break
                if not self._futures and all(
                    t.is_finished() or t.status == PAUSED for t in self.trials
                ):
                    paused = [t for t in self.trials if t.status == PAUSED]
                    if paused and self._running_count() < self._max_concurrent:
                        continue  # scheduler may resume paused trials next step
                    if self._searcher_exhausted or (
                        self.num_samples_cap is not None
                        and len(self.trials) >= self.num_samples_cap
                    ):
                        break
                    if self._next_trial() is None:
                        break
        finally:
            # An exception out of the loop leaves no trial's actor (nor its
            # gang) behind; on a normal end none is left to kill.
            for trial_id in list(self._actors):
                try:
                    ray_tpu_torch.kill(self._actors.pop(trial_id))
                except exceptions.RayTpuError:
                    pass  # the actor is already gone
        self._save_experiment_state()
        return self.trials

    @staticmethod
    def _fire(cb, hook: str, **kwargs) -> None:
        handler = getattr(cb, hook, None)
        if handler:
            try:
                handler(**kwargs)
            except Exception:
                # User callbacks must not kill the trial loop, but their
                # bugs must not vanish either (reference logs these too).
                logger.warning("callback %s raised", hook, exc_info=True)

    # -- experiment state (Tuner.restore) --

    def _save_experiment_state(self) -> None:
        state = {
            "trainable_name": self.trainable_name,
            "metric": self.metric,
            "mode": self.mode,
            "searcher": self._try(self.searcher.save),
            "trials": [t.to_json() for t in self.trials],
        }
        path = os.path.join(self.experiment_dir, EXPERIMENT_STATE_FILE)
        try:
            atomic_write_json(path, state, default=str)
        except TypeError:  # unserializable user state: a restore restarts fresh, by design
            pass

    @staticmethod
    def _try(fn):
        try:
            return fn()
        except Exception:  # probe helper: callers treat None as unavailable
            return None

    def restore_experiment_state(self, resume_errored: bool = False) -> None:
        path = os.path.join(self.experiment_dir, EXPERIMENT_STATE_FILE)
        if not os.path.exists(path):
            return
        with open(path) as f:
            state = json.load(f)
        if state.get("searcher") is not None:
            self._try(lambda: self.searcher.restore(state["searcher"]))
        for tdata in state["trials"]:
            trial = Trial.from_json(tdata, self.experiment_dir)
            if trial.status == ERROR and resume_errored:
                trial.num_failures = 0
                trial.set_status(PENDING)
            self.trials.append(trial)
            self.scheduler.on_trial_add(self, trial)
