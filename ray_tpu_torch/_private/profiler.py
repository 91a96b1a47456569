"""Step profiler: the per-worker capture plane, on ``torch.profiler``.

Copy of ray_tpu's ``_private/profiler.py`` with its device trace on
``torch.profiler`` in place of ``jax.profiler``. Every train worker owns one
:class:`ProfilePlane`: a small state machine (``idle → armed → capturing →
done``) that the trainer drives through its report round
(``TorchTrainer.capture_profile``). Arming names a *future step boundary*,
so every selected rank starts its capture at the same global step; the
boundary hook rides the StepStats report path (``train/step_stats.py``), so
a worker pays one module-bool check per report and nothing else.

A capture gathers three layers, all bounded:

  * the device trace: a ``torch.profiler.profile`` with CPU and CUDA
    activity (CPU alone on a worker whose device is the CPU), started at the
    capture's start edge, stepped at every boundary inside the window (the
    trace holds one ``ProfilerStep#k`` range a step) and exported at the
    stop as ``<out_dir>/rank<r>-device/trace.json`` (Chrome trace format,
    loads in ui.perfetto.dev). Best-effort: a trace that cannot start (a
    manual ``start_trace`` owns the profiler, no card) leaves a host-only
    capture with ``device_error`` set;
  * a host sampling profiler (:class:`HostSampler`): a daemon thread
    walking ``sys._current_frames()`` at ``RAY_TPU_PROFILE_HOST_HZ``,
    folding stacks in place. Threads that exit mid-walk are skipped, the
    sampler never samples itself, and a fork (pid change) stops it;
  * the annotation buffer: ``step_annotation()`` slices (fwd/bwd/opt,
    per-bucket fence waits) and phase totals, which the trainer merges into
    ONE Perfetto trace (``profile_merge``) and reads the hot phase from.

``torch.profiler`` keeps its state with the thread that started it: a stop
from another thread does nothing, and an export after it crashes the
process. The capture starts on the train loop's thread (inside ``report``);
where the leak guard's timer or an abort ends it from another thread, the
plane hands the running profiler to that loop thread, which stops and
exports it at its next boundary hook or when the session ends
(:func:`release_device_trace`).

Knobs (all env):

  RAY_TPU_PROFILE_HOST_HZ           host sampler frequency   (50)
  RAY_TPU_PROFILE_MAX_S             hard cap per capture     (60)
  RAY_TPU_PROFILE_DIR_TTL_S         profile-dir GC TTL       (3600)
  RAY_TPU_PROFILE_AUTO              auto-capture enabled     (1)
  RAY_TPU_PROFILE_AUTO_STEPS        steps per auto capture   (3)
  RAY_TPU_PROFILE_AUTO_COOLDOWN_S   min between auto runs    (300)
  RAY_TPU_PROFILE_AUTO_CONSECUTIVE  straggler cuts to arm    (2)

The AUTO knobs are read by the flight recorder's driver half
(``train.step_stats.FlightRecorder``), whose auto-capture goes through the
trainer's ``capture_profile`` queue.
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import sys
import tempfile
import threading
import time

logger = logging.getLogger(__name__)

# Bounds that are invariants, not tunables.
_MAX_STACK_DEPTH = 64
_MAX_FOLDED_KEYS = 50_000
_MAX_ANNOTATIONS = 50_000
_TIMER_GRACE_S = 5.0


def knob_float(name: str, default: float) -> float:
    raw = os.environ.get(f"RAY_TPU_PROFILE_{name}")
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def knob_int(name: str, default: int) -> int:
    return int(knob_float(name, float(default)))


def knob_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(f"RAY_TPU_PROFILE_{name}")
    if raw is None:
        return default
    return raw.lower() in ("1", "true", "yes", "on")


def profiles_base_dir(session_dir: str | None = None) -> str:
    """``<session_dir>/profiles``; without a session dir, under the process's
    temporary directory."""
    root = (session_dir or os.environ.get("RAYTPU_SESSION_DIR")
            or os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
    return os.path.join(root, "profiles")


def gc_profile_dirs(base: str, ttl_s: float | None = None) -> int:
    """Remove profile output dirs older than the TTL (session-scoped GC —
    before this, `rpc_profiler` dirs accumulated forever). Returns the
    number of entries removed; never raises."""
    if ttl_s is None:
        ttl_s = knob_float("DIR_TTL_S", 3600.0)
    removed = 0
    try:
        entries = os.listdir(base)
    except OSError:
        return 0
    cutoff = time.time() - max(0.0, ttl_s)
    for name in entries:
        path = os.path.join(base, name)
        try:
            if os.path.getmtime(path) >= cutoff:
                continue
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.unlink(path)
            removed += 1
        except OSError:
            continue  # raced with another GC / still being written
    return removed


# -- host sampling profiler ----------------------------------------------
class HostSampler:
    """Periodic ``sys._current_frames()`` walk folding stacks in place.

    Robustness contract (satellite: "sampling a thread that exits
    mid-capture cannot crash the worker"):

      * thread names come from a fresh ``threading.enumerate()`` each
        sample — a tid whose Thread object is gone (exited between
        enumerate and the frames snapshot, or tid reused by a brand-new
        native thread) is evicted, never walked with a stale identity
        (mirror of the memory monitor's pid-reuse handle eviction),
      * the frame walk is bounded (depth cap) and exception-guarded —
        a frame torn down mid-walk drops that one sample,
      * the sampler skips its own thread and stops itself after a fork
        (``os.getpid()`` drift) so a forked child never inherits a
        sampling thread ghost.
    """

    def __init__(self, hz: float | None = None):
        self.hz = max(1.0, hz if hz is not None else knob_float("HOST_HZ", 50.0))
        self._interval = 1.0 / self.hz
        self._folded: dict[str, int] = {}
        self._samples = 0
        self._dropped = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._pid = os.getpid()
        self._lock = threading.Lock()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="raytpu-host-sampler", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:  # a torn sample must never kill the capture thread
                self._dropped += 1
            self._stop.wait(self._interval)

    def sample_once(self) -> None:
        if os.getpid() != self._pid:
            # Forked child: the cached identity is stale — evict ourselves.
            self._stop.set()
            return
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate() if t.ident}
        frames = sys._current_frames()
        folded_batch: list[str] = []
        for tid, frame in frames.items():
            if tid == me:
                continue
            name = names.get(tid)
            if name is None:
                # Dead-thread / tid-reuse eviction: no live Thread object
                # claims this tid right now — do not walk it.
                continue
            stack: list[str] = []
            try:
                f = frame
                depth = 0
                while f is not None and depth < _MAX_STACK_DEPTH:
                    code = f.f_code
                    stack.append(
                        f"{code.co_name} "
                        f"({os.path.basename(code.co_filename)}:{f.f_lineno})"
                    )
                    f = f.f_back
                    depth += 1
            except Exception:  # frame freed mid-walk: drop this thread's sample
                self._dropped += 1
                continue
            stack.reverse()
            folded_batch.append(name + ";" + ";".join(stack))
        del frames
        with self._lock:
            self._samples += 1
            for key in folded_batch:
                if key in self._folded:
                    self._folded[key] += 1
                elif len(self._folded) < _MAX_FOLDED_KEYS:
                    self._folded[key] = 1
                else:
                    self._dropped += 1

    def stop(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._lock:
            return {
                "folded": dict(self._folded),
                "samples": self._samples,
                "dropped": self._dropped,
                "hz": self.hz,
            }


# -- device trace (torch.profiler) ----------------------------------------
TRACE_FILE = "trace.json"
# The one torch.profiler session of this process (a capture's or a manual
# one), and a session whose stop came from a thread that does not own it,
# waiting for its owner (see the module docstring).
_live: "_DeviceTrace | None" = None
_pending: "_DeviceTrace | None" = None
_atexit_registered = False


class _DeviceTrace:
    """A running ``torch.profiler.profile`` that exports ``trace.json`` into
    ``out_dir`` when it stops. Only its owner thread may step or stop it."""

    def __init__(self, out_dir: str, device):
        global _live, _atexit_registered
        from torch.profiler import ProfilerAction, ProfilerActivity, profile

        if _live is not None:
            raise RuntimeError(
                f"a profiler trace into {_live.out_dir} is already running in this process")
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.out_dir = out_dir
        self.cuda = device.type == "cuda"
        self.owner = threading.get_ident()
        # A schedule that records every step: profile.step() then closes one
        # ProfilerStep#k range and opens the next.
        self._prof = profile(activities=activities,
                             schedule=lambda step: ProfilerAction.RECORD)
        self._prof.start()
        _live = self
        if not _atexit_registered:
            atexit.register(release_device_trace)
            _atexit_registered = True

    def owned(self) -> bool:
        return threading.get_ident() == self.owner

    def step(self) -> None:
        self._prof.step()

    def stop(self) -> str | None:
        """Stops the trace and writes ``trace.json``; the error, or None.
        The card's queued work is waited for first, so the trace holds the
        window's last kernels."""
        global _live
        _live = None
        try:
            if self.cuda:
                import torch

                torch.cuda.synchronize()
            self._prof.stop()
            self._prof.export_chrome_trace(os.path.join(self.out_dir, TRACE_FILE))
        except Exception as exc:  # the host capture stands without the device trace
            return str(exc)
        return None


def _stop_or_hand_off(trace: _DeviceTrace) -> str | None:
    """Stops ``trace`` on its owner thread; elsewhere leaves it to the owner's
    next boundary hook or session end. Returns the stop's error."""
    global _pending
    if trace.owned():
        return trace.stop()
    _pending = trace
    return None


def _flush_pending() -> None:
    """Stops and exports a trace another thread stopped, when this thread
    owns it."""
    global _pending
    if _pending is not None and _pending.owned():
        trace, _pending = _pending, None
        error = trace.stop()
        if error:
            logger.warning("device trace into %s failed at its stop: %s", trace.out_dir, error)


def release_device_trace() -> None:
    """Ends what this thread owns of the profiler: a capture still running
    (aborted: its step stream ended) and a trace another thread stopped.
    The session calls it when the train loop ends, and ``atexit`` at exit."""
    plane = _plane
    if plane is not None and plane.state in ("armed", "capturing"):
        trace = plane._trace
        if trace is None or trace.owned():
            plane.abort()
    _flush_pending()


# -- capture plane --------------------------------------------------------
# Module-level fast flags: the per-report boundary hook and the
# per-annotation hooks check ONE bool before touching the plane.
_boundary_armed = False
_capturing = False


class ProfilePlane:
    """Per-worker capture state machine, driven by the trainer's report
    round (``arm``, ``abort``, ``collect``) and the step-boundary hook."""

    def __init__(self):
        self._lock = threading.Lock()
        self.state = "idle"  # idle | armed | capturing | done
        self.rank: int | None = None
        self.node_id: str = ""
        self.worker_id: str = ""
        # The worker's device ("cuda:0", "cpu"); None: the card.
        self.device: str | None = None
        self.last_step: int | None = None
        self._capture_id: str | None = None
        self._start_step: int | None = None
        self._steps = 0
        self._end_step: int | None = None
        self._host = True
        self._device = True
        self._out_dir: str | None = None
        self._sampler: HostSampler | None = None
        self._boundaries: list[dict] = []
        self._annotations: list[dict] = []
        self._phase_totals: dict[str, float] = {}
        self._device_dir: str | None = None
        self._device_error: str | None = None
        self._trace: _DeviceTrace | None = None
        self._timer: threading.Timer | None = None
        self._wall_start = 0.0
        self._result: dict | None = None
        self._timed_out = False

    def set_meta(
        self,
        rank: int | None = None,
        node_id: str | None = None,
        worker_id: str | None = None,
        device: str | None = None,
    ) -> None:
        if rank is not None:
            self.rank = int(rank)
        if node_id is not None:
            self.node_id = node_id
        if worker_id is not None:
            self.worker_id = worker_id
        if device is not None:
            self.device = device

    # -- control (the trainer's report round) ---------------------------
    def arm(self, payload: dict) -> dict:
        global _boundary_armed
        with self._lock:
            if self.state in ("armed", "capturing"):
                return {
                    "status": "error",
                    "code": "already_active",
                    "error": f"capture {self._capture_id} is {self.state}",
                }
            capture_id = str(payload.get("capture_id") or "manual")
            start_step = payload.get("start_step")
            steps = max(1, int(payload.get("steps") or 1))
            max_s = float(payload.get("max_s") or knob_float("MAX_S", 60.0))
            self._capture_id = capture_id
            self._start_step = (
                int(start_step) if start_step is not None else None
            )
            self._steps = steps
            self._end_step = None
            self._host = bool(payload.get("host", True))
            self._device = bool(payload.get("device", True))
            base = profiles_base_dir(payload.get("session_dir"))
            gc_profile_dirs(base)
            self._out_dir = os.path.join(base, capture_id)
            self._boundaries = []
            self._annotations = []
            self._phase_totals = {}
            self._device_dir = None
            self._device_error = None
            self._result = None
            self._timed_out = False
            self.state = "armed"
            _boundary_armed = True
            # Leak guard: whatever happens to the step stream (loop ends,
            # non-train worker, controller dies), the capture force-stops.
            self._timer = threading.Timer(
                max_s + _TIMER_GRACE_S, self._on_timeout
            )
            self._timer.daemon = True
            self._timer.start()
            if self._start_step is None:
                # No step stream to align on (non-train worker): start now.
                self._begin_locked()
        return {
            "status": "ok",
            "state": self.state,
            "capture_id": self._capture_id,
            "start_step": self._start_step,
        }

    def status(self) -> dict:
        with self._lock:
            return {
                "status": "ok",
                "state": self.state,
                "capture_id": self._capture_id,
                "rank": self.rank,
                "step": self.last_step,
                "start_step": self._start_step,
            }

    def collect(self) -> dict:
        global _boundary_armed
        with self._lock:
            if self.state in ("armed", "capturing"):
                return {
                    "status": "error",
                    "code": "not_done",
                    "error": f"capture {self._capture_id} still {self.state}",
                }
            if self._result is None:
                return {
                    "status": "error",
                    "code": "no_capture",
                    "error": "no completed capture to collect",
                }
            result, self._result = self._result, None
            self.state = "idle"
            _boundary_armed = False
            return {"status": "ok", **result}

    def abort(self) -> dict:
        with self._lock:
            if self.state == "armed":
                self._finish_locked(aborted=True)
                return {"status": "ok", "state": self.state}
            if self.state == "capturing":
                self._stop_locked(aborted=True)
                return {"status": "ok", "state": self.state}
            return {"status": "ok", "state": self.state}

    # -- step-boundary hook (report path) -------------------------------
    def on_step_boundary(self, step: int) -> None:
        with self._lock:
            self.last_step = step
            if self.state == "armed":
                if (
                    self._start_step is not None
                    and step + 1 >= self._start_step
                ):
                    # This boundary is the start edge of step `step+1`.
                    self._begin_locked()
                    self._note_boundary_locked(step)
                return
            if self.state == "capturing":
                self._note_boundary_locked(step)
                if (
                    self._end_step is not None
                    and step >= self._end_step
                ):
                    self._stop_locked()
                elif self._trace is not None and self._trace.owned():
                    self._trace.step()  # the next ProfilerStep#k range

    # -- annotation hooks (step_annotation / record_phase) --------------
    def note_annotation(self, name: str, wall_start: float, dur_s: float) -> None:
        with self._lock:
            if self.state != "capturing":
                return
            if len(self._annotations) >= _MAX_ANNOTATIONS:
                return
            self._annotations.append(
                {"name": name, "ts": wall_start, "dur_s": dur_s}
            )

    def note_phase(self, phase: str, seconds: float) -> None:
        with self._lock:
            if self.state != "capturing":
                return
            self._phase_totals[phase] = (
                self._phase_totals.get(phase, 0.0) + float(seconds)
            )

    # -- internals (all called with self._lock held) --------------------
    def _begin_locked(self) -> None:
        global _capturing
        self.state = "capturing"
        self._wall_start = time.time()
        first = (
            self.last_step + 1
            if self.last_step is not None
            else (self._start_step or 0)
        )
        self._end_step = first + self._steps - 1
        if self._host:
            self._sampler = HostSampler()
            self._sampler.start()
        if self._device:
            self._start_device_trace_locked()
        _capturing = True

    def _note_boundary_locked(self, step: int) -> None:
        # The reference joins its span tracer's trace and span ids here
        # (``tracing.inject()``); that tracer is runtime, not ported, so the
        # marks carry no ids and the merged trace's ``trace_ids`` is empty.
        self._boundaries.append({"step": step, "ts": time.time()})

    def _start_device_trace_locked(self) -> None:
        try:
            from ray_tpu_torch import resolve_device

            rank = self.rank if self.rank is not None else "x"
            self._device_dir = os.path.join(
                self._out_dir or profiles_base_dir(), f"rank{rank}-device"
            )
            device = resolve_device(self.device)
            os.makedirs(self._device_dir, exist_ok=True)
            self._trace = _DeviceTrace(self._device_dir, device)
        except Exception as exc:  # device trace is best-effort; host capture proceeds
            self._device_error = str(exc)
            self._device_dir = None

    def _stop_locked(self, aborted: bool = False) -> None:
        global _capturing
        _capturing = False
        host = self._sampler.stop() if self._sampler is not None else None
        self._sampler = None
        if self._trace is not None:
            trace, self._trace = self._trace, None
            error = _stop_or_hand_off(trace)
            if error:
                self._device_error = error
        self._finish_locked(aborted=aborted, host=host)

    def _finish_locked(self, aborted: bool = False, host: dict | None = None) -> None:
        global _boundary_armed
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._result = {
            "capture_id": self._capture_id,
            "rank": self.rank,
            "node_id": self.node_id,
            "worker_id": self.worker_id,
            "wall_start": self._wall_start,
            "wall_end": time.time(),
            "aborted": bool(aborted),
            "timed_out": self._timed_out,
            "boundaries": list(self._boundaries),
            "annotations": list(self._annotations),
            "phase_totals": dict(self._phase_totals),
            "host": host,
            "device_trace_dir": self._device_dir,
            "device_error": self._device_error,
        }
        self.state = "done"
        _boundary_armed = True  # keep hook routing until collect() resets

    def _on_timeout(self) -> None:
        with self._lock:
            self._timed_out = True
            if self.state == "capturing":
                self._stop_locked()
            elif self.state == "armed":
                # Never started (step stream stalled or absent): finish
                # empty so the controller's collect sees a typed record
                # instead of a leaked armed plane.
                self._finish_locked(aborted=True)


_plane: ProfilePlane | None = None
_plane_lock = threading.Lock()


def get_plane() -> ProfilePlane:
    global _plane
    if _plane is None:
        with _plane_lock:
            if _plane is None:
                _plane = ProfilePlane()
    return _plane


# -- hot-path hooks (one module-bool check when idle) ---------------------
def on_step_boundary(step: int) -> None:
    if _pending is not None:
        _flush_pending()
    if not _boundary_armed:
        return
    get_plane().on_step_boundary(step)


def note_annotation(name: str, wall_start: float, dur_s: float) -> None:
    if not _capturing:
        return
    get_plane().note_annotation(name, wall_start, dur_s)


def note_phase(phase: str, seconds: float) -> None:
    if not _capturing:
        return
    get_plane().note_phase(phase, seconds)


def capturing() -> bool:
    return _capturing


# -- manual trace (the reference's rpc_profiler "start" / "stop") ---------
_manual: _DeviceTrace | None = None


def start_trace(log_dir: str | None = None, device=None) -> dict:
    """Starts a device trace outside any coordinated capture, into
    ``log_dir`` (default ``<profiles>/worker-<pid>``), on the card unless
    ``device`` says otherwise. Typed errors: ``already_started``,
    ``plane_active`` (a capture owns the profiler), ``start_failed``."""
    global _manual
    if _manual is not None:
        return {"status": "error", "code": "already_started",
                "error": "profiler already running"}
    if get_plane().state in ("armed", "capturing"):
        return {"status": "error", "code": "plane_active",
                "error": "a coordinated capture owns the profiler"}
    base = profiles_base_dir()
    gc_profile_dirs(base)
    log_dir = log_dir or os.path.join(base, f"worker-{os.getpid()}")
    try:
        from ray_tpu_torch import resolve_device

        resolved = resolve_device(device)
        os.makedirs(log_dir, exist_ok=True)
        _manual = _DeviceTrace(log_dir, resolved)
    except Exception as exc:
        return {"status": "error", "code": "start_failed", "error": str(exc)}
    return {"status": "ok", "log_dir": log_dir}


def stop_trace() -> dict:
    """Stops the manual trace and writes ``<log_dir>/trace.json``. Called
    from a thread other than the one that started it, the export waits for
    that thread's next hook (``"deferred": True``). Typed errors:
    ``not_started``, ``stop_failed``."""
    global _manual
    if _manual is None:
        return {"status": "error", "code": "not_started",
                "error": "profiler not running"}
    trace, _manual = _manual, None
    deferred = not trace.owned()
    error = _stop_or_hand_off(trace)
    if error:
        return {"status": "error", "code": "stop_failed", "error": error}
    return {"status": "ok", "log_dir": trace.out_dir, "deferred": deferred}
