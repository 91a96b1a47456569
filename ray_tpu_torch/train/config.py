"""The trainer's config dataclasses: the subset ``TorchTrainer`` reads.

Copies of ray_tpu's ``train/config.py`` (``ScalingConfig``, ``RunConfig``,
``FailureConfig``, ``CheckpointConfig``). ``ScalingConfig`` keeps
``num_workers`` and ``mesh_axes`` and asks for GPUs where the reference
asks for TPU chips (``use_gpu``: one card a worker, the counterpart of
``resources={"TPU": n}``), and the pipeline fields (``pipeline_stages``,
``microbatches``, ``virtual_stages``) with the reference's validation, and
``slice_topology``. Left out, with the runtime they need: elastic sizes and
placement (ROADMAP Queue A item 4); and, until a caller needs them, the
workers' extra environment, fail-fast, scored checkpoint retention,
callbacks and stop criteria.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass
class ScalingConfig:
    """How many gang workers, on what device, over what mesh.

    num_workers -- gang size: one process a device.
    use_gpu     -- one CUDA card a worker, NCCL between them; False runs
                   the workers on the CPU over gloo.
    mesh_axes   -- named axis sizes of the mesh the workers build (the
                   session's ``get_context().mesh``); {} means dp over
                   every worker (every worker not consumed as a pipeline
                   stage).
    pipeline_stages -- with more than 1, worker rank i runs pipeline stage
                   i // (num_workers / pipeline_stages)
                   (``train.stage_runner.PipelineStageRunner``), each batch
                   cut into ``microbatches`` and scheduled 1F1B;
                   num_workers must be a multiple of it.
    virtual_stages -- model chunks per stage rank (interleaved 1F1B),
                   shrinking the bubble from (S-1)/(M+S-1) to
                   (S-1)/(v*M+S-1); above 1 it needs microbatches
                   divisible by pipeline_stages.
    slice_topology -- a ``parallel.topology.SliceTopology`` composing DCN
                   axes across domains with ICI axes within them; workers
                   read it from the train context
                   (``get_context().slice_topology``), and the session's
                   mesh is built from it.
    """

    num_workers: int = 1
    use_gpu: bool = True
    mesh_axes: Mapping[str, int] = field(default_factory=dict)
    pipeline_stages: int = 1
    microbatches: int = 1
    virtual_stages: int = 1
    slice_topology: Any = None

    def factorization(self) -> dict[str, int]:
        """The (dp, fsdp, tp, pp) this config asks for: pp from
        pipeline_stages (or mesh_axes when that is 1)."""
        pp = int(self.pipeline_stages)
        axes = dict(self.mesh_axes) or {"dp": self.num_workers // pp}
        out = {a: int(axes.get(a, 1)) for a in ("dp", "fsdp", "tp", "pp")}
        if pp > 1:
            out["pp"] = pp
        return out

    def __post_init__(self) -> None:
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.pipeline_stages < 1 or self.microbatches < 1:
            raise ValueError("pipeline_stages and microbatches must be >= 1")
        if self.virtual_stages < 1:
            raise ValueError("virtual_stages must be >= 1")
        if self.virtual_stages > 1 and self.microbatches % self.pipeline_stages != 0:
            raise ValueError(
                f"interleaved 1F1B (virtual_stages={self.virtual_stages}) needs microbatches "
                f"divisible by pipeline_stages, got microbatches={self.microbatches} "
                f"pipeline_stages={self.pipeline_stages}")
        if self.pipeline_stages > 1 and self.num_workers % self.pipeline_stages != 0:
            raise ValueError(
                f"num_workers={self.num_workers} must be a multiple of "
                f"pipeline_stages={self.pipeline_stages} (each stage is a gang of "
                f"num_workers/pipeline_stages workers)")

    def pipeline(self, attempt: int = 0) -> dict | None:
        """What each worker's ``TrainContext.pipeline`` starts from (its
        stage and rank in the stage are added per worker); None without
        pipeline stages."""
        if self.pipeline_stages <= 1:
            return None
        return {"num_stages": int(self.pipeline_stages), "microbatches": int(self.microbatches),
                "virtual": int(self.virtual_stages), "attempt": int(attempt)}


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
