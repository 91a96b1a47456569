"""Trainable — the unit of execution Tune schedules.

Role-equivalent of python/ray/tune/trainable/trainable.py :: Trainable and
function_trainable.py :: wrap_function. Two API shapes, same as the
reference:

  * class API — subclass Trainable, implement setup/step/save_checkpoint/
    load_checkpoint; the controller calls train() per iteration.
  * function API — def train_fn(config): ... ray_tpu.tune.report(...) —
    wrapped into a Trainable that runs the function on a background thread
    and hands results over a rendezvous queue (one result per train() call),
    mirroring the reference's FunctionTrainable/_StatusReporter design.

Copied from ray_tpu's ``tune/trainable.py``. Each trial runs in a process
of its own (``execution/tune_controller.py``), which receives the user's
function or class by module and qualified name and wraps it there: the
class ``wrap_function`` builds lives inside a function, so no pickle
takes it, and the wrapped function is kept on it as ``_train_fn`` for the
controller to send. ``with_parameters`` returns an instance of a
module-level class for the same reason (the reference returns a closure).
Stopping a function trainable waits for its thread, up to
``STOP_JOIN_S``, so that what the function started (a ``TorchTrainer``'s
gang) is shut down before the trial's actor answers ``stop``.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Any, Callable, Optional

DONE = "done"
TRAINING_ITERATION = "training_iteration"
# How long stop() waits for a function trainable's thread to end; under
# the controller's 5 s wait for the answer to stop.
STOP_JOIN_S = 4.0


class Trainable:
    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self._iteration = 0
        self._start_time = time.time()
        self.setup(self.config)

    # -- subclass surface --
    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        """Return a picklable blob capturing trainable state."""
        return None

    def load_checkpoint(self, checkpoint: Any) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        """In-place config swap (PBT explore). False = controller must
        restart the trial's actor instead."""
        return False

    def cleanup(self) -> None:
        pass

    # -- controller surface (called over the trial's pipe) --
    def train(self) -> dict:
        result = self.step() or {}
        self._iteration += 1
        result.setdefault(TRAINING_ITERATION, self._iteration)
        result.setdefault("time_total_s", time.time() - self._start_time)
        result.setdefault(DONE, False)
        return result

    def save(self) -> Any:
        return self.save_checkpoint()

    def restore(self, checkpoint: Any) -> None:
        self.load_checkpoint(checkpoint)

    def reset(self, new_config: dict) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = new_config
        return ok

    def stop(self) -> None:
        self.cleanup()


class _Session:
    """Per-trial function-API session: report() rendezvous + checkpointing.

    The function thread blocks in report() until the controller consumes the
    result via train() — preserving the reference's lockstep semantics so
    schedulers can pause/stop between iterations.
    """

    def __init__(self, config: dict, checkpoint: Any = None):
        self.config = config
        self.loaded_checkpoint = checkpoint
        self.saved_checkpoint: Any = None
        self._results: queue.Queue = queue.Queue(maxsize=1)
        self._pending_ckpt: Any = None
        self._consumed = threading.Event()
        self._consumed.set()
        self._stop = threading.Event()

    def report(self, metrics: dict, checkpoint: Any = None) -> None:
        if self._stop.is_set():
            raise StopIteration("trial stopped")
        if checkpoint is not None:
            self.saved_checkpoint = checkpoint
            self._pending_ckpt = checkpoint
        self._results.put(dict(metrics))
        self._consumed.wait()
        self._consumed.clear()
        if self._stop.is_set():
            raise StopIteration("trial stopped")

    def get_checkpoint(self) -> Any:
        return self.loaded_checkpoint


_session_lock = threading.Lock()
_current_session: Optional[_Session] = None


def _set_session(session: Optional[_Session]) -> None:
    global _current_session
    with _session_lock:
        _current_session = session


def report(metrics: dict, *, checkpoint: Any = None) -> None:
    """ray_tpu.tune.report — called from inside a function trainable."""
    if _current_session is None:
        raise RuntimeError("tune.report() called outside a Tune session")
    _current_session.report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Any:
    if _current_session is None:
        return None
    return _current_session.get_checkpoint()


def wrap_function(train_fn: Callable[[dict], Any]) -> type:
    """Build a Trainable class around a function trainable."""

    class FunctionTrainable(Trainable):
        _name = getattr(train_fn, "__name__", "func")

        def setup(self, config: dict) -> None:
            self._session = _Session(config)
            self._thread: threading.Thread | None = None
            self._error: list[BaseException] = []
            self._fn_done = threading.Event()

        def _runner(self) -> None:
            _set_session(self._session)
            try:
                train_fn(self.config)
            except StopIteration:
                pass
            except BaseException as exc:  # surfaces via train()
                exc._tb = traceback.format_exc()  # type: ignore
                self._error.append(exc)
            finally:
                self._fn_done.set()
                _set_session(None)

        def _ensure_thread(self) -> None:
            if self._thread is None:
                self._thread = threading.Thread(target=self._runner, daemon=True)
                self._thread.start()

        def step(self) -> dict:
            self._ensure_thread()
            while True:
                try:
                    metrics = self._session._results.get(timeout=0.05)
                    # A checkpoint reported alongside metrics rides the
                    # result dict so the controller can persist it even
                    # without a checkpoint_freq-triggered save().
                    if self._session._pending_ckpt is not None:
                        metrics["__checkpoint__"] = self._session._pending_ckpt
                        self._session._pending_ckpt = None
                    self._session._consumed.set()
                    return metrics
                except queue.Empty:
                    if self._error:
                        raise self._error[0]
                    if self._fn_done.is_set():
                        return {DONE: True}

        def save_checkpoint(self) -> Any:
            return self._session.saved_checkpoint

        def load_checkpoint(self, checkpoint: Any) -> None:
            self._session.loaded_checkpoint = checkpoint

        def cleanup(self) -> None:
            self._session._stop.set()
            self._session._consumed.set()
            # The thread runs a report ahead of the controller, and that
            # report may wait for room in the queue: make it, so the thread
            # reaches the stop check. It ends there (the report raises),
            # and with it what the function started, such as a
            # TorchTrainer's gang.
            try:
                self._session._results.get_nowait()
            except queue.Empty:
                pass
            if self._thread is not None:
                self._thread.join(STOP_JOIN_S)

    FunctionTrainable.__name__ = f"func_{getattr(train_fn, '__name__', 'trainable')}"
    FunctionTrainable._train_fn = staticmethod(train_fn)
    return FunctionTrainable


class _WithParameters:
    """``fn(config, **params)``: a module-level class, so that stdlib
    pickle takes it to the trial's actor (by ``fn``'s qualified name and
    the parameters' values)."""

    def __init__(self, fn: Callable, params: dict):
        self.fn, self.params = fn, params
        self.__name__ = getattr(fn, "__name__", "trainable")

    def __call__(self, config: dict):
        return self.fn(config, **self.params)


def with_parameters(fn: Callable, **params) -> Callable:
    """ray.tune.with_parameters-equivalent: close large objects over the
    trainable without putting them in the config dict. ``fn`` must be
    defined at the top level of an importable module, and ``params``
    picklable: both go to the trial's actor."""
    return _WithParameters(fn, params)


class _WithResources:
    """``fn`` with the resources each of its trials' actors leases."""

    def __init__(self, fn: Callable, resources: dict):
        self.fn, self.resources = fn, {k: float(v) for k, v in resources.items()}
        self.__name__ = getattr(fn, "__name__", "trainable")

    def __call__(self, config: dict):
        return self.fn(config)


def with_resources(fn: Callable, resources: dict) -> Callable:
    """ray.tune.with_resources-equivalent: each trial of ``fn`` leases
    ``resources`` (the runtime's keys: ``{"CPU": 1, "GPU": 0.125}``) in
    place of the default ``{"CPU": 1}``; a trial that runs on a card must
    ask for a share of one, or it sees none. ``fn`` must be defined at the
    top level of an importable module."""
    return _WithResources(fn, resources)
