"""StepStats recording: the worker half of the flight recorder.

Copy of the worker half of ray_tpu's ``train/_internal/step_stats.py``:

  * a per-process phase accumulator: the collective ops, the overlap
    handle's fence, the sharded checkpoint writer and the pipeline stage
    runner call :func:`record_phase` with measured wall time;
    ``activate()``/``deactivate()`` gate it, so outside a train session a
    call costs one bool check;
  * :func:`step_annotation`, a named sub-step scope: it opens
    ``torch.profiler.record_function(name)`` (where the reference opens
    ``jax.profiler.TraceAnnotation``), so a device trace carries the same
    name, times the block, attributes the time to a phase (fwd/bwd/opt)
    when asked, and buffers the slice for the merged trace while a capture
    runs;
  * :class:`StepRecorder`: the session calls ``on_report()`` once per
    ``report()``; it cuts one StepStats record covering the interval since
    the previous report: wall time, data wait, collective, checkpoint and
    pipeline-bubble time (drained from the accumulator), compute as the
    remainder and its fwd/bwd/opt split, plus tokens and FLOPs when the
    user's metrics carry them (keys ``tokens`` and ``flops``, per rank per
    step). The record's keys are the reference's.

The driver half (``FlightRecorder``: goodput buckets, the gang aggregator,
the straggler scan and the capture it triggers) feeds the controller's
workload store, which is runtime; it waits for ROADMAP item 8b, and the
trainer keeps each rank's records in ``Result.step_stats`` meanwhile.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any

from ray_tpu_torch._private import profiler as profiler_mod


def enabled() -> bool:
    """The reference reads its controller's config here; the port has no
    controller config, so recording is on."""
    return True


# -- worker-side phase accumulator --------------------------------------
_phase_lock = threading.Lock()
_phase_acc: dict[str, float] = {}
_active = False


def activate() -> None:
    global _active
    with _phase_lock:
        _phase_acc.clear()
    _active = True


def deactivate() -> None:
    global _active
    _active = False
    with _phase_lock:
        _phase_acc.clear()


def record_phase(phase: str, seconds: float) -> None:
    """Attribute ``seconds`` of the current step to ``phase``. Hot-path
    safe: outside an active train session this is one bool check."""
    if not _active:
        return
    if seconds <= 0:
        return
    with _phase_lock:
        _phase_acc[phase] = _phase_acc.get(phase, 0.0) + float(seconds)
    # Phase totals during a capture window feed the hot-phase attribution.
    # One module-bool check when idle.
    profiler_mod.note_phase(phase, seconds)


@contextlib.contextmanager
def step_annotation(name: str, phase: str | None = None):
    """Named sub-step scope: opens ``torch.profiler.record_function(name)``
    so the device trace carries the same name, times the block, attributes
    the wall time to a StepStats ``phase`` (fwd/bwd/opt) when asked, and,
    only while a capture is live, buffers the slice for the merged trace.
    Idle cost: a timer read pair and a ``record_function`` that no
    profiler observes."""
    from torch.profiler import record_function

    wall0 = time.time()
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        if phase is not None:
            record_phase(phase, dt)
        profiler_mod.note_annotation(name, wall0, dt)


def _drain_phases() -> dict[str, float]:
    with _phase_lock:
        out = dict(_phase_acc)
        _phase_acc.clear()
    return out


def _device_info() -> tuple[str, int]:
    """(device kind, local device count): the card's name and the visible
    cards, probed only when the process already initialised CUDA (telemetry
    never forces a CUDA init), else ("", 1)."""
    import torch

    if not torch.cuda.is_initialized():
        return "", 1
    try:
        return torch.cuda.get_device_name(torch.cuda.current_device()), torch.cuda.device_count()
    except RuntimeError:
        return "", 1


class StepRecorder:
    """Cuts one StepStats record per ``report()`` on a worker."""

    def __init__(self, ctx: Any):
        self.ctx = ctx
        self.step = -1
        self._last = time.perf_counter()
        self._last_wait = 0.0
        self._device_kind: str | None = None
        self._devices = 1
        # The capture plane learns this worker's identity here, so that a
        # trainer-armed capture can align on the step stream and trace the
        # worker's device.
        profiler_mod.get_plane().set_meta(
            rank=ctx.world_rank, node_id=ctx.node_id,
            device=getattr(ctx, "device", None) or None,
        )

    def _data_wait_total(self) -> float:
        total = 0.0
        for shard in (getattr(self.ctx, "dataset_shards", None) or {}).values():
            wait = getattr(shard, "fetch_wait_s", None)
            if isinstance(wait, (int, float)):
                total += float(wait)
        return total

    def on_report(self, metrics: dict) -> dict:
        now = time.perf_counter()
        wall = max(0.0, now - self._last)
        self._last = now
        wait_total = self._data_wait_total()
        data_wait = min(wall, max(0.0, wait_total - self._last_wait))
        self._last_wait = wait_total
        phases = _drain_phases()
        collective = min(wall, phases.get("collective", 0.0))
        checkpoint = min(wall, phases.get("checkpoint", 0.0))
        # Pipeline-stage recv waits (stage_runner): schedule bubble, not
        # compute, subtracted from the remainder like the other phases.
        pp_bubble = min(wall, phases.get("pp_bubble", 0.0))
        # Overlapped gradient sync: collective keeps the TOTAL op time, but
        # only the fence-blocked slice stole wall clock from the step, so
        # when the overlap path ran the compute remainder subtracts the
        # exposed time instead of the total.
        comm_exposed = min(wall, phases.get("comm_exposed", 0.0))
        comm_blocking = comm_exposed if "comm_exposed" in phases else collective
        compute = max(
            0.0, wall - data_wait - comm_blocking - checkpoint - pp_bubble
        )
        # Sub-step attribution: step_annotation() scopes split the compute
        # remainder into fwd/bwd/opt. The split is clamped so fwd+bwd+opt
        # never exceeds compute (annotation walls can overlap phases
        # already subtracted above); compute itself is unchanged.
        fwd = phases.get("fwd", 0.0)
        bwd = phases.get("bwd", 0.0)
        opt = phases.get("opt", 0.0)
        sub = fwd + bwd + opt
        if sub > compute > 0.0:
            scale = compute / sub
            fwd, bwd, opt = fwd * scale, bwd * scale, opt * scale
        elif sub > 0.0 and compute <= 0.0:
            fwd = bwd = opt = 0.0
            sub = 0.0
        if self._device_kind is None:
            self._device_kind, self._devices = _device_info()
        self.step += 1
        rec = {
            "step": self.step,
            "ts": time.time(),
            "rank": self.ctx.world_rank,
            "node_id": self.ctx.node_id,
            "wall_s": wall,
            "data_wait_s": data_wait,
            "compute_s": compute,
            "collective_s": collective,
            "checkpoint_s": checkpoint,
            "pp_bubble_s": pp_bubble,
            "comm_exposed_s": comm_exposed,
        }
        if sub > 0.0:
            rec["fwd_s"] = fwd
            rec["bwd_s"] = bwd
            rec["opt_s"] = opt
        # Step boundary for the capture plane: this report ends step
        # `self.step`; an armed capture starts or stops exactly here, so
        # every selected rank cuts on the same global step edge.
        profiler_mod.on_step_boundary(self.step)
        tokens = metrics.get("tokens")
        if isinstance(tokens, (int, float)) and not isinstance(tokens, bool):
            rec["tokens"] = float(tokens)
        flops = metrics.get("flops")
        if isinstance(flops, (int, float)) and not isinstance(flops, bool):
            rec["flops"] = float(flops)
        if self._device_kind:
            rec["device_kind"] = self._device_kind
            rec["devices"] = self._devices
        return rec

    def mark_resume(self) -> None:
        """Exclude the driver's report rendezvous from the next wall.

        ``report()`` blocks until the trainer has consumed the round, so
        every rank resumes on the same round edge, gated by the slowest
        rank. Without this re-stamp that block lands in the NEXT step's wall
        and every rank's wall converges to the gang round period. The
        session calls this after the hand-off, so walls measure the rank's
        own step, not the driver's backpressure."""
        self._last = time.perf_counter()
