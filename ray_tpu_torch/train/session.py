"""The per-worker train session: ``report``, ``get_context`` and
``get_checkpoint`` inside ``train_loop_per_worker``.

Copy of ray_tpu's ``train/_internal/session.py`` (``TrainContext``,
``_Session``) and of the functions ``train/__init__.py`` exports. As in the
reference, the user's loop runs on a thread of the gang member and the
trainer polls it with actor calls (``next_result``); ``report`` hands
(metrics, checkpoint) to the poll, then blocks until the trainer's answer
to the round comes with its next poll: an ``ack``, which lets the loop go
on, or a ``stop``, which ends it (``TrainingStopped``). That is a lockstep
barrier across ranks, as the reference's.

Each rank's dataset shards (``TorchTrainer(datasets=...)``) are in
``TrainContext.dataset_shards`` and ``get_dataset_shard(name)``; each report
carries a snapshot of every resumable shard's position (``state_dict()``),
which the trainer stamps into the checkpoint it commits, as the reference's
session does.

Each report carries a StepStats record (``train.step_stats.StepRecorder``)
cut before the hand-off, and the step clock restarts after the trainer's
ack, as the reference's session does. The report round also carries the
trainer's profile captures: an ack may hold an ``arm`` or ``abort`` for
this worker's capture plane, and the next report brings back the arm's
answer and, once the capture has ended, the capture itself.
"""

from __future__ import annotations

import contextvars
import queue
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ray_tpu_torch._private import profiler as profiler_mod
from ray_tpu_torch.train import step_stats as step_stats_mod
from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class TrainContext:
    """What ``get_context()`` returns inside a worker."""

    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    node_id: str = ""
    experiment_name: str = ""
    trial_dir: str = ""
    train_loop_config: dict = field(default_factory=dict)
    latest_checkpoint: Optional[Checkpoint] = None
    mesh: Any = None
    collective_group: str = ""
    # The worker's device ("cuda:<rank>" or "cpu"), where its mesh is built.
    device: str = ""
    # With ScalingConfig.pipeline_stages > 1: {num_stages, microbatches,
    # virtual, attempt, stage, stage_rank}; else None.
    pipeline: Optional[dict] = None
    # ScalingConfig.slice_topology (a parallel.topology.SliceTopology), which
    # torch_utils.build_mesh(topology=...) and the session's mesh take.
    slice_topology: Any = None
    # name -> this rank's shard: a data.DataIterator for a Dataset, a
    # strided slice for a list, the object itself otherwise.
    dataset_shards: dict = field(default_factory=dict)

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_dir(self) -> str:
        return self.trial_dir


class TrainingStopped(Exception):
    """The trainer ended the run while this worker was reporting."""


class _Session:
    def __init__(self, ctx: TrainContext):
        self.ctx = ctx
        self._recorder = (step_stats_mod.StepRecorder(ctx) if step_stats_mod.enabled()
                          else None)
        if self._recorder is not None:
            step_stats_mod.activate()
        self._arm_reply: dict | None = None
        # One report (or the loop's end) at a time toward the trainer, one
        # answer back.
        self._results: queue.Queue = queue.Queue(maxsize=1)
        self._replies: queue.Queue = queue.Queue(maxsize=1)

    def start(self, fn: Callable[[], Any]) -> None:
        """Runs ``fn`` (the user's loop) on a thread of its own; its end,
        or its exception, is the poll's last answer."""
        # The loop runs in the caller's context: under the member's
        # ``execute`` span, which its profiler step marks then carry.
        context = contextvars.copy_context()
        threading.Thread(target=context.run, args=(self._run, fn), name="train-loop",
                         daemon=True).start()

    def _run(self, fn: Callable[[], Any]) -> None:
        final: dict = {"done": True}
        try:
            fn()
        except BaseException as exc:
            final = {"error": repr(exc), "traceback": traceback.format_exc()}
        # Closed on the loop's thread, which owns the device trace.
        capture = shutdown_session()
        if "done" in final:
            final["profile"] = capture
        # Every report was answered before the loop went on, so the queue
        # has room.
        self._results.put(final)

    def next_result(self, reply: tuple | None = None, timeout: float = 0.0) -> dict | None:
        """Called by the trainer's poll: hands the loop ``reply`` (the
        answer to its last report), then returns the next report, or the
        loop's end (``{"done": True, "profile": ...}``, ``{"error": ...,
        "traceback": ...}``), or None when neither came within ``timeout``
        seconds."""
        if reply is not None:
            self._replies.put(reply)
        try:
            return self._results.get(timeout=timeout)
        except queue.Empty:
            return None

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None) -> None:
        # This rank's dataset positions beside the report: the trainer
        # stamps them into the checkpoint it commits, so a restart at any
        # world size resumes ingest exactly.
        ingest = {name: shard.state_dict()
                  for name, shard in (self.ctx.dataset_shards or {}).items()
                  if getattr(shard, "supports_state", False)}
        # Cut the StepStats record BEFORE blocking on the trainer: the
        # step's interval covers the user's work, not the round's wait. Its
        # boundary hook may start or end a capture.
        stats = self._recorder.on_report(metrics) if self._recorder is not None else None
        payload = {"metrics": dict(metrics), "checkpoint": checkpoint, "step_stats": stats,
                   "ingest": ingest or None}
        profile = self._profile_out()
        if profile:
            payload["profile"] = profile
        self._results.put(payload)
        reply = self._replies.get()
        if reply[0] != "ack":
            raise TrainingStopped(f"the trainer answered the report with {reply[0]!r}")
        if len(reply) > 1 and reply[1].get("profile"):
            self._profile_in(reply[1]["profile"])
        # Restart the step clock AFTER the hand-off: the wait above is the
        # round's rendezvous, not this rank's step.
        if self._recorder is not None:
            self._recorder.mark_resume()

    def _profile_out(self) -> dict:
        """What this report tells the trainer of its capture: the answer to
        the last arm, and the capture once it has ended."""
        out = {}
        if self._arm_reply is not None:
            out["arm"], self._arm_reply = self._arm_reply, None
        plane = profiler_mod.get_plane()
        if plane.state == "done":
            out["capture"] = plane.collect()
        return out

    def _profile_in(self, action: dict) -> None:
        """An ``arm`` or ``abort`` the trainer sent with its ack, run on the
        loop's thread (the one that owns the device trace)."""
        plane = profiler_mod.get_plane()
        if action.get("action") == "arm":
            self._arm_reply = plane.arm(action)
        elif action.get("action") == "abort":
            plane.abort()

    def close(self) -> dict | None:
        """Ends the session's recording: a capture still running is
        aborted and its trace written; returns that capture, if any."""
        step_stats_mod.deactivate()
        profiler_mod.release_device_trace()
        plane = profiler_mod.get_plane()
        return plane.collect() if plane.state == "done" else None


_session: _Session | None = None


def init_session(ctx: TrainContext) -> _Session:
    global _session
    _session = _Session(ctx)
    return _session


def get_session() -> _Session:
    if _session is None:
        raise RuntimeError(
            "report()/get_context() called outside a train worker: they only work inside "
            "train_loop_per_worker"
        )
    return _session


def in_session() -> bool:
    return _session is not None


def shutdown_session() -> dict | None:
    """Ends the session; returns a capture that ended with it (see
    ``_Session.close``)."""
    global _session
    session, _session = _session, None
    return session.close() if session is not None else None


def report(metrics: dict, *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Reports metrics (and a checkpoint) from a train worker. Blocks until
    the trainer consumed the round: a lockstep barrier across ranks."""
    get_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return get_session().ctx


def get_dataset_shard(name: str = "train"):
    """This rank's shard of the trainer's dataset ``name``, or None."""
    return get_session().ctx.dataset_shards.get(name)


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint this run resumes from, or None."""
    return get_session().ctx.latest_checkpoint
