"""TuneController — THE trial event loop.

Role-equivalent of python/ray/tune/execution/tune_controller.py ::
TuneController (SURVEY §2.5, §3.3): asks the searcher for configs, launches
trials, consumes intermediate results, consults the scheduler
(CONTINUE/PAUSE/STOP), persists experiment state for resume, restarts failed
trials from their last checkpoint, and supports PBT checkpoint transplants.

Port of ray_tpu's ``tune/execution/tune_controller.py``. The reference runs
each trial as a runtime actor (``_TrialActor``); the port has no runtime,
so each trial is a process of its own (``_TrialProcess``):

* Spawn. The trial's process comes from the ``spawn`` context and is not
  daemonic: a trainer trial starts its own ``WorkerGang``, and
  ``multiprocessing`` forbids children of daemonic processes. It leads a
  process group of its own.
* Interface. It answers ``train`` / ``save`` / ``restore`` / ``reset`` /
  ``stop`` over a pipe, with the reference's timeouts (``CALL_TIMEOUT_S``,
  ``RESTORE_TIMEOUT_S``, ``STOP_TIMEOUT_S``). Each call carries a number
  and its answer the same, so a ``save`` asked of a trial whose ``train``
  is still running (PBT's donor) waits behind it, as an actor's calls
  queue. The loop waits on the pipes with
  ``multiprocessing.connection.wait(..., timeout=1.0)`` where the
  reference calls ``ray_tpu.wait``.
* Pickling the trainable. There is no cloudpickle: the user's function or
  class goes by module and qualified name (``TrainableRef``, as serve's
  ``CallableRef`` sends deployments) and is wrapped (``wrap_function``)
  inside the trial's process; a callable instance (the Tuner's trainer
  wrapper, ``with_parameters``) goes as stdlib pickle, its class and the
  functions it holds again by name. A trainable defined under
  ``<locals>`` raises ``ValueError``.
* Checkpoints that outlive their process. Every message is stdlib
  ``pickle`` bytes, so tensors cross by value. Once ``torch.multiprocessing``
  is imported, ``multiprocessing``'s own pickler sends a CUDA tensor as a
  CUDA IPC handle and a CPU tensor as shared memory, and both die with the
  trial that saved them: ``_complete_trial`` kills a trial right after its
  last save, and PBT restores a donor's checkpoint into another trial.
* Stopped trials orphan no gang. ``_kill_actor`` asks the trial to stop (a
  function trainable's ``stop`` waits for its thread, and so for a
  ``TorchTrainer``'s gang to shut down), waits up to ``STOP_TIMEOUT_S``
  for the answer, then kills the trial's process group: a trial killed
  hard takes its gang members with it, where a member alone would only
  notice its parent's death at its next pipe read.
* Resources. A trial's process starts only once this process's resource
  ledger (``_private.resources``) places ``resources_per_trial``, every
  key of it, as the reference hands every key to its runtime; the lease
  goes back when the process ends (``_kill_actor``, and the error paths
  through it). A trial that does not place stays PENDING until one that
  runs frees its resources, and one asking for a key the host never
  declared stays PENDING, as the reference's infeasible actor waits. A
  trial asking for ``GPU`` gets ``CUDA_VISIBLE_DEVICES`` set to the cards
  it was given (serve's replicas get theirs the same way); one asking for
  none sees the host's cards.
* Concurrency. The ledger's CPU total over the trial's CPUs, as the
  reference divides its cluster's CPUs; ``max_concurrent_trials``
  overrides it.
"""

from __future__ import annotations

import importlib
import json
import logging
import multiprocessing
import os
import pickle
import signal
import time
import traceback
import types
from multiprocessing.connection import wait
from typing import Any, Optional

from ray_tpu_torch._private import resources
from ray_tpu_torch.tune.experiment.trial import (
    ERROR, PAUSED, PENDING, RUNNING, TERMINATED, Trial, atomic_write_json,
)
from ray_tpu_torch.tune.schedulers.trial_scheduler import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.trainable import wrap_function

EXPERIMENT_STATE_FILE = "experiment_state.json"

# The reference's timeouts: a result, save, reset or a transplant's restore
# (60 s), the restore that starts a trial (120 s, which here includes the
# process's start), and stop (5 s) before the kill.
CALL_TIMEOUT_S = 60.0
RESTORE_TIMEOUT_S = 120.0
STOP_TIMEOUT_S = 5.0
# How long a kill may take to end every process of the trial's group.
KILL_WAIT_S = 10.0
# How long a step with no call outstanding waits when a trial could not be
# placed, before it asks the ledger again.
PLACEMENT_POLL_S = 0.1

logger = logging.getLogger(__name__)


class TrialError(RuntimeError):
    """A trainable's call raised in its trial's process, or the process
    died; the message holds the trial's traceback."""


def _lookup(module: str, qualname: str) -> Any:
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


class TrainableRef:
    """A trainable on its way to a trial's process. A function or a
    ``Trainable`` subclass goes by module and qualified name and is
    imported there; a function trainable is wrapped there. A callable
    instance goes as stdlib pickle bytes."""

    def __init__(self, trainable_cls: type):
        fn = getattr(trainable_cls, "_train_fn", None)
        self.wrap = fn is not None
        target = fn if self.wrap else trainable_cls
        self.module = self.qualname = self.payload = None
        if isinstance(target, (type, types.FunctionType)):
            self.module, self.qualname = target.__module__, target.__qualname__
            if "<locals>" in self.qualname:
                raise ValueError(
                    f"{self.module}.{self.qualname}: a trainable must be defined at the top "
                    f"level of an importable module (each trial's process imports it by name)")
            try:
                found = _lookup(self.module, self.qualname)
            except (ImportError, AttributeError):
                found = None
            if found is not target:
                raise ValueError(
                    f"{self.module}.{self.qualname} is not reachable by its name: a trainable "
                    f"must be defined at the top level of an importable module (each trial's "
                    f"process imports it by name)")
        else:
            try:
                self.payload = pickle.dumps(target)
            except (pickle.PicklingError, AttributeError, TypeError) as exc:
                raise ValueError(
                    f"{target!r} does not pickle: a callable trainable's class, and the "
                    f"functions and objects it holds, must be defined at the top level of an "
                    f"importable module (each trial's process imports them by name): {exc}"
                ) from exc

    def resolve(self) -> type:
        """The Trainable class, in the trial's process."""
        if self.payload is not None:
            target = pickle.loads(self.payload)
        else:
            target = _lookup(self.module, self.qualname)
        return wrap_function(target) if self.wrap else target


def _group_running(pgid: int) -> bool:
    """Whether any process of group ``pgid`` still runs (a zombie, which
    holds no memory or device, counts as ended)."""
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:  # the process ended while we looked
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            return True
    return False


def _error_text(exc: BaseException) -> str:
    tb = getattr(exc, "_tb", None) or traceback.format_exc()
    return f"{type(exc).__name__}: {exc}\n{tb}"


def _trial_main(spec: bytes, conn) -> None:
    """A trial's process: builds the trainable, then answers the
    controller's calls, in order, until ``stop``."""
    # A group of its own: the controller's kill reaches the gang members a
    # trainer trial starts.
    os.setpgrp()
    trainable, failed = None, None
    try:
        ref, config = pickle.loads(spec)
        trainable = ref.resolve()(config)
    except Exception as exc:  # every call answers with it
        failed = _error_text(exc)
    while True:
        try:
            seq, method, args = pickle.loads(conn.recv_bytes())
        except EOFError:  # the controller is gone
            return
        if failed is not None:
            reply = (seq, "error", failed)
        else:
            try:
                reply = (seq, "ok", getattr(trainable, method)(*args))
            except Exception as exc:
                reply = (seq, "error", _error_text(exc))
        try:
            data = pickle.dumps(reply)
        except Exception as exc:  # a result or checkpoint stdlib pickle refuses
            data = pickle.dumps((seq, "error", _error_text(exc)))
        conn.send_bytes(data)
        if method == "stop":
            return


class _TrialProcess:
    """One trial's process and the controller's end of its pipe: the
    reference's ``_TrialActor`` handle. ``submit`` returns a call's number;
    ``result`` waits for that call's answer."""

    def __init__(self, ref: TrainableRef, config: dict, name: str,
                 visible_devices: str | None = None):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        # Not daemonic: a trainer trial's gang members are its children.
        self.process = ctx.Process(target=_trial_main, args=(pickle.dumps((ref, config)), child),
                                   name=name, daemon=False)
        with resources.child_visible_devices(visible_devices):
            self.process.start()
        child.close()
        self._seq = 0
        self._replies: dict[int, tuple] = {}
        self._dead = False

    def submit(self, method: str, *args) -> int:
        self._seq += 1
        try:
            self.conn.send_bytes(pickle.dumps((self._seq, method, args)))
        except OSError:  # the process is gone: the call's result says so
            self._dead = True
        return self._seq

    def pull(self, timeout: float) -> None:
        """Reads one answer into the buffer; an answer that does not come
        within ``timeout`` raises TimeoutError."""
        if not self.conn.poll(timeout):
            raise TimeoutError(f"{self.process.name} answered nothing within {timeout} s")
        try:
            seq, kind, value = pickle.loads(self.conn.recv_bytes())
        except (EOFError, OSError):
            self._dead = True
            return
        self._replies[seq] = (kind, value)

    def has_reply(self, seq: int) -> bool:
        return seq in self._replies or self._dead

    def result(self, seq: int, timeout: float) -> Any:
        deadline = time.monotonic() + timeout
        while not self.has_reply(seq):
            self.pull(max(0.0, deadline - time.monotonic()))
        if seq not in self._replies:
            self.process.join(1.0)
            raise TrialError(f"{self.process.name} died (exit code {self.process.exitcode})")
        kind, value = self._replies.pop(seq)
        if kind == "error":
            raise TrialError(value)
        return value

    def call(self, method: str, *args, timeout: float) -> Any:
        return self.result(self.submit(method, *args), timeout)

    def kill(self) -> None:
        """Kills the trial's process group (the process and the gang
        members a trainer trial may have left), reaps the process and
        waits, up to ``KILL_WAIT_S``, until no process of the group runs."""
        pgid = self.process.pid
        try:
            os.killpg(pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):  # the group is gone
            pass
        if self.process.exitcode is None:  # killed before it made its group
            self.process.kill()
        self.process.join()
        self.conn.close()
        deadline = time.monotonic() + KILL_WAIT_S
        while _group_running(pgid) and time.monotonic() < deadline:
            time.sleep(0.01)


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
        self._actors: dict[str, _TrialProcess] = {}  # trial_id -> its process
        self._leases: dict[str, resources.Lease] = {}  # trial_id -> what it holds
        self._unplaced_warned: set[str] = set()
        # (process, call number) of an outstanding train() -> Trial
        self._futures: dict[tuple[_TrialProcess, int], Trial] = {}
        self._searcher_exhausted = False
        if max_concurrent_trials:
            self._max_concurrent = max_concurrent_trials
        else:
            cpus = resources.cluster_resources().get("CPU", 4)
            per_trial = max(self.resources_per_trial.get("CPU", 1), 0.01)
            self._max_concurrent = max(1, int(cpus / per_trial))

    # -- scheduler hooks --

    @property
    def live_trials(self) -> list[Trial]:
        return [t for t in self.trials if not t.is_finished()]

    def transplant_trial(self, trial: Trial, donor: Trial, new_config: dict) -> None:
        """PBT exploit: copy donor's latest checkpoint + new config into
        trial's process (reset in place or recreate)."""
        donor_proc = self._actors.get(donor.trial_id)
        if donor_proc is not None:
            try:
                donor.checkpoint = donor_proc.call("save", timeout=CALL_TIMEOUT_S)
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
        proc = self._actors.get(trial.trial_id)
        if proc is None:
            return
        try:
            in_place = proc.call("reset", new_config, timeout=CALL_TIMEOUT_S)
        except Exception:
            in_place = False
        if not in_place:
            self._drop_pending_future(trial)
            self._kill_actor(trial)
            if not self._start_trial_actor(trial):
                trial.set_status(PENDING)  # restarts once its resources free
        elif trial.checkpoint is not None:
            proc.call("restore", trial.checkpoint, timeout=CALL_TIMEOUT_S)

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

    def _start_trial_actor(self, trial: Trial) -> bool:
        """Starts the trial's process once the ledger places its resources;
        False, and nothing started, while it cannot."""
        try:
            lease = resources.ledger().acquire(self.resources_per_trial)
        except resources.PlacementGroupUnschedulableError as exc:
            if trial.trial_id not in self._unplaced_warned:
                self._unplaced_warned.add(trial.trial_id)
                logger.warning("trial %s waits for resources: %s", trial.trial_id, exc)
            return False
        self._leases[trial.trial_id] = lease
        visible = (lease.visible_devices() if self.resources_per_trial.get("GPU", 0) > 0
                   else None)
        try:
            proc = _TrialProcess(self._ref, trial.config,
                                 name=f"trial-{self.trainable_name}-{trial.trial_id}",
                                 visible_devices=visible)
        except BaseException:
            self._leases.pop(trial.trial_id).release()
            raise
        self._actors[trial.trial_id] = proc
        if trial.checkpoint is not None:
            proc.call("restore", trial.checkpoint, timeout=RESTORE_TIMEOUT_S)
        trial.set_status(RUNNING)
        self._futures[(proc, proc.submit("train"))] = trial
        return True

    def _kill_actor(self, trial: Trial) -> None:
        proc = self._actors.pop(trial.trial_id, None)
        if proc is None:
            return
        try:
            proc.call("stop", timeout=STOP_TIMEOUT_S)
        except Exception:  # stop timed out or the process is gone; the kill follows
            pass
        proc.kill()
        self._leases.pop(trial.trial_id).release()

    def _drop_pending_future(self, trial: Trial) -> None:
        for key, t in list(self._futures.items()):
            if t is trial:
                del self._futures[key]

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
            if not self._start_trial_actor(choice):
                if not self._futures:  # nothing of ours to free it: wait a little
                    time.sleep(PLACEMENT_POLL_S)
                break

        if not self._futures:
            return

        # 2. consume one completed train() (the reference's num_returns=1),
        # the first in submission order
        if not any(proc.has_reply(seq) for proc, seq in self._futures):
            by_conn = {proc.conn: proc for proc, _ in self._futures}
            for conn in wait(list(by_conn), timeout=1.0):
                by_conn[conn].pull(0.0)
        ready = next((key for key in self._futures if key[0].has_reply(key[1])), None)
        if ready is None:
            return
        trial = self._futures.pop(ready)
        try:
            result = ready[0].result(ready[1], timeout=CALL_TIMEOUT_S)
        except Exception as exc:
            self._handle_trial_error(trial, exc)
            return
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
            proc := self._actors.get(trial.trial_id)
        ):
            try:
                ckpt = proc.call("save", timeout=CALL_TIMEOUT_S)
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
            proc = self._actors.get(trial.trial_id)
            if proc is not None:
                self._futures[(proc, proc.submit("train"))] = trial
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
            # An exception out of the loop leaves no trial's process (nor
            # its gang) behind; on a normal end none is left to kill.
            for trial_id in list(self._actors):
                self._actors.pop(trial_id).kill()
                self._leases.pop(trial_id).release()
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
