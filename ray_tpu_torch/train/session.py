"""The per-worker train session: ``report``, ``get_context`` and
``get_checkpoint`` inside ``train_loop_per_worker``.

Copy of ray_tpu's ``train/_internal/session.py`` (``TrainContext``) and of
the functions ``train/__init__.py`` exports. The reference runs the user's
loop on a thread and the trainer polls it; here the loop runs in the gang
member's main thread and ``report`` hands (metrics, checkpoint) to the
trainer over the member's channel, then blocks until the trainer has
consumed the round: a lockstep barrier across ranks, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

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

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None) -> None:
        self._channel.send(("report", {"metrics": dict(metrics), "checkpoint": checkpoint}))
        reply = self._channel.recv()
        if reply[0] != "ack":
            raise TrainingStopped(f"the trainer answered the report with {reply[0]!r}")


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


def shutdown_session() -> None:
    global _session
    _session = None


def report(metrics: dict, *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Reports metrics (and a checkpoint) from a train worker. Blocks until
    the trainer consumed the round: a lockstep barrier across ranks."""
    get_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return get_session().ctx


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint this run resumes from, or None."""
    return get_session().ctx.latest_checkpoint
