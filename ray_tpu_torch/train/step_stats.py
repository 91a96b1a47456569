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

The driver half is :class:`FlightRecorder`, a copy of the reference's:
the trainer folds each report round's records into the gang aggregator
(``_private.workload.StepStatsAggregator``), which gives rolling tokens/s,
MFU and the MAD straggler scan; a rank flagged on
``RAY_TPU_PROFILE_AUTO_CONSECUTIVE`` summary cuts in a row triggers one
capture, queued through the trainer's own ``capture_profile`` queue where
the reference calls its controller; and the run's wall clock is cut into
goodput buckets (checkpoint, restart, stalled, productive) for
``Result.goodput``. The reference pushes its samples to the controller's
workload store (``_maybe_push``); the port has no store yet (ROADMAP
item 14), so the samples stay in the recorder (``FlightRecorder.samples``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any

from ray_tpu_torch._private import profiler as profiler_mod

# The rolling summary and the straggler scan walk the whole window, so a
# round cuts one at most this often and the rounds in between reuse it
# (the reference cuts on its push cadence, of the same period).
_SUMMARY_INTERVAL_S = 1.0
_MAX_SAMPLES = 4096  # per series, as the reference bounds its buffer
# The straggler threshold is median + k * MAD over the gang's step walls
# (the reference's configured default).
STRAGGLER_MAD_K = 3.0


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


# -- driver side ---------------------------------------------------------
class FlightRecorder:
    """The driver's aggregator, goodput accountant and straggler watch.

    ``request_capture(steps=, ranks=, reason=)`` queues a capture (the
    trainer's ``_queue_capture``); None turns the auto-capture's request
    into a no-op, as the reference's fails without a controller."""

    def __init__(self, experiment: str, request_capture=None):
        from ray_tpu_torch._private.workload import StepStatsAggregator

        self.experiment = experiment
        self.agg = StepStatsAggregator()
        self.request_capture = request_capture
        self._t0 = time.monotonic()
        self.buckets = {
            "checkpoint_s": 0.0,
            "restart_s": 0.0,
            "stalled_s": 0.0,
        }
        self._last_progress: float | None = None
        self.samples: dict[str, list[dict]] = {}
        self._summary: dict | None = None
        self._last_summary = 0.0
        self.stragglers: list[dict] = []
        # Ranks flagged straggler on consecutive summary cuts debounce-
        # trigger one bounded capture.
        self._straggler_streak: dict[int, int] = {}
        self._last_auto_req = 0.0

    # -- goodput wall-clock buckets -------------------------------------
    def note_restart(self, seconds: float) -> None:
        self.buckets["restart_s"] += max(0.0, seconds)

    def note_checkpoint(self, seconds: float) -> None:
        self.buckets["checkpoint_s"] += max(0.0, seconds)

    def note_progress(self) -> None:
        self._last_progress = time.monotonic()

    def note_stalled_since_progress(self) -> None:
        """The failure path: everything since the last committed round is
        lost work and detection time, the stalled bucket."""
        if self._last_progress is not None:
            self.buckets["stalled_s"] += max(0.0, time.monotonic() - self._last_progress)
            self._last_progress = None

    def goodput(self) -> dict:
        from ray_tpu_torch._private.workload import goodput_buckets

        return goodput_buckets(time.monotonic() - self._t0, **self.buckets)

    # -- per-round ingest -----------------------------------------------
    def on_round(self, round_results: list) -> dict | None:
        """Ingests one round's per-rank StepStats. Returns the rolling gang
        summary (tokens/s, MFU, phase fractions), or None until a round has
        carried records."""
        self.note_progress()
        max_ckpt = 0.0
        saw = False
        for result in round_results:
            rec = result.get("step_stats") if isinstance(result, dict) else None
            if not isinstance(rec, dict):
                continue
            if self.agg.add(rec):
                saw = True
                max_ckpt = max(max_ckpt, float(rec.get("checkpoint_s") or 0.0))
                self._queue(f"train/{self.experiment}/rank{rec.get('rank', 0)}", rec)
        if not saw:
            return self._summary
        # Workers save sharded checkpoints inside the step; the slowest
        # rank's save time is wall clock the gang spent checkpointing.
        self.buckets["checkpoint_s"] += max_ckpt
        now = time.monotonic()
        if self._summary is None or now - self._last_summary >= _SUMMARY_INTERVAL_S:
            self._last_summary = now
            self._summary = self._cut_gang_sample()
        return self._summary

    def _cut_gang_sample(self) -> dict:
        """The rolling gang summary and the straggler scan, kept as one
        ``train/<experiment>`` sample."""
        summary = self.agg.summary()
        self.stragglers = self.agg.straggler_report(k=STRAGGLER_MAD_K)
        if self.stragglers:
            summary["stragglers"] = [s["rank"] for s in self.stragglers]
        self._maybe_auto_profile()
        self._queue(f"train/{self.experiment}", {"ts": time.time(), **summary})
        return summary

    def _maybe_auto_profile(self) -> None:
        """Debounces straggler flags into ONE capture request: a rank must
        stay flagged for RAY_TPU_PROFILE_AUTO_CONSECUTIVE summary cuts, and
        requests are at least RAY_TPU_PROFILE_AUTO_COOLDOWN_S apart."""
        if not self.stragglers:
            self._straggler_streak.clear()
            return
        if not profiler_mod.knob_bool("AUTO", True):
            return
        flagged = {int(s["rank"]) for s in self.stragglers if "rank" in s}
        for rank in list(self._straggler_streak):
            if rank not in flagged:
                del self._straggler_streak[rank]
        need = profiler_mod.knob_int("AUTO_CONSECUTIVE", 2)
        ready = []
        for rank in sorted(flagged):
            streak = self._straggler_streak.get(rank, 0) + 1
            self._straggler_streak[rank] = streak
            if streak >= need:
                ready.append(rank)
        if not ready:
            return
        now = time.monotonic()
        cooldown = profiler_mod.knob_float("AUTO_COOLDOWN_S", 300.0)
        if self._last_auto_req and now - self._last_auto_req < cooldown:
            return
        self._last_auto_req = now
        for rank in ready:
            self._straggler_streak[rank] = 0
        if self.request_capture is not None:
            self.request_capture(steps=profiler_mod.knob_int("AUTO_STEPS", 3), ranks=ready,
                                 reason="straggler")

    def _queue(self, key: str, sample: dict) -> None:
        kept = self.samples.setdefault(key, [])
        kept.append(sample)
        if len(kept) > _MAX_SAMPLES:
            del kept[: len(kept) - _MAX_SAMPLES]

    def finalize(self) -> dict:
        """The end of fit(): the final goodput, kept with a last gang
        sample; returns the buckets for ``Result.goodput``."""
        g = self.goodput()
        if self.agg.records_ingested:
            # The summary's cadence may have left the last steps out.
            self._summary = self._cut_gang_sample()
        self._queue(f"train/{self.experiment}/goodput", {"ts": time.time(), **g})
        return g
