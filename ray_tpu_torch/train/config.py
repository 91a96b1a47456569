"""The trainer's config dataclasses: the subset ``TorchTrainer`` reads.

Copies of ray_tpu's ``train/config.py`` (``ScalingConfig``, ``RunConfig``,
``FailureConfig``, ``CheckpointConfig``). ``ScalingConfig`` keeps
``num_workers`` and ``mesh_axes`` and asks for GPUs where the reference
asks for TPU chips (``use_gpu``: one card a worker, the counterpart of
``resources={"TPU": n}``). Left out, with the runtime they need: elastic
sizes, placement, topology and pipeline stages (ROADMAP Queue A item 4);
and, until a caller needs them, the workers' extra environment, fail-fast,
scored checkpoint retention, callbacks and stop criteria.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Mapping


@dataclass
class ScalingConfig:
    """How many gang workers, on what device, over what mesh.

    num_workers -- gang size: one process a device.
    use_gpu     -- one CUDA card a worker, NCCL between them; False runs
                   the workers on the CPU over gloo.
    mesh_axes   -- named axis sizes of the mesh the workers build (the
                   session's ``get_context().mesh``); {} means dp over
                   every worker.
    """

    num_workers: int = 1
    use_gpu: bool = True
    mesh_axes: Mapping[str, int] = field(default_factory=dict)

    def factorization(self) -> dict[str, int]:
        """The (dp, fsdp, tp, pp) this config asks for."""
        axes = dict(self.mesh_axes) or {"dp": self.num_workers}
        return {a: int(axes.get(a, 1)) for a in ("dp", "fsdp", "tp", "pp")}

    def __post_init__(self) -> None:
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")


@dataclass
class FailureConfig:
    """max_failures: gang restarts from the latest checkpoint before the run
    is declared failed. 0 = fail fast; -1 = retry forever."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """num_to_keep: retain only the last K persisted checkpoints."""

    num_to_keep: int | None = None

    def __post_init__(self) -> None:
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


@dataclass
class RunConfig:
    """Where results and checkpoints land (a local path) and how failures
    are handled."""

    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)

    def resolved_storage_path(self) -> str:
        return os.path.expanduser(self.storage_path or "~/ray_tpu_results")
