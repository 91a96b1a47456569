"""The per-worker train session: ``report``, ``get_context`` and
``get_checkpoint`` inside ``train_loop_per_worker``.

Copy of ray_tpu's ``train/_internal/session.py`` (``TrainContext``) and of
the functions ``train/__init__.py`` exports. The reference runs the user's
loop on a thread and the trainer polls it; here the loop runs in the gang
member's main thread and ``report`` hands (metrics, checkpoint) to the
trainer over the member's channel, then blocks until the trainer has
consumed the round: a lockstep barrier across ranks, as the reference's.

Each report carries a StepStats record (``train.step_stats.StepRecorder``)
cut before the hand-off, and the step clock restarts after the trainer's
ack, as the reference's session does. The report round also carries the
trainer's profile captures: an ack may hold an ``arm`` or ``abort`` for
this worker's capture plane, and the next report brings back the arm's
answer and, once the capture has ended, the capture itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

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
    def __init__(self, ctx: TrainContext, channel):
        self.ctx = ctx
        self._channel = channel
        self._recorder = (step_stats_mod.StepRecorder(ctx) if step_stats_mod.enabled()
                          else None)
        if self._recorder is not None:
            step_stats_mod.activate()
        self._arm_reply: dict | None = None

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None) -> None:
        # Cut the StepStats record BEFORE blocking on the trainer: the
        # step's interval covers the user's work, not the round's wait. Its
        # boundary hook may start or end a capture.
        stats = self._recorder.on_report(metrics) if self._recorder is not None else None
        payload = {"metrics": dict(metrics), "checkpoint": checkpoint, "step_stats": stats}
        profile = self._profile_out()
        if profile:
            payload["profile"] = profile
        self._channel.send(("report", payload))
        reply = self._channel.recv()
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


def init_session(ctx: TrainContext, channel) -> _Session:
    global _session
    _session = _Session(ctx, channel)
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


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint this run resumes from, or None."""
    return get_session().ctx.latest_checkpoint
