"""The trainer's config dataclasses: the subset ``TorchTrainer`` reads.

Copies of ray_tpu's ``train/config.py`` (``ScalingConfig``, ``RunConfig``,
``FailureConfig``, ``CheckpointConfig``). ``ScalingConfig`` keeps
``num_workers`` and ``mesh_axes`` and asks for GPUs where the reference
asks for TPU chips (``use_gpu``: one card a worker, the counterpart of
``resources={"TPU": n}``), and the pipeline fields (``pipeline_stages``,
``microbatches``, ``virtual_stages``) with the reference's validation, and
``slice_topology``, and bounded elasticity (``min_workers``, the
formation timeout and the grow-back probe's period) with the resources a
worker leases from the host's ledger (``resources_per_worker``,
``worker_resources()``), and ``collective_config``. ``RunConfig`` keeps ``callbacks`` (``on_result``
each report round), ``stop`` and ``verbose``, and ``CheckpointConfig``
``checkpoint_frequency``, which Tune reads. Left out, with the runtime
they need: placement strategies across hosts (ROADMAP Queue A item 4) and
drains on out-of-memory telemetry (``drain_on_oom_risk``, item 14, which
raises); and, until a caller needs them, the workers' extra environment,
fail-fast and scored checkpoint retention.
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
    resources_per_worker -- what each worker leases from the host's
                   resource ledger beside its CPU (and its card under
                   use_gpu), e.g. {"trainslot": 1}.
    min_workers -- bounded elasticity: None keeps the world size fixed.
                   With it set, a gang that cannot form at num_workers
                   forms at the largest size down to min_workers that
                   places, and grows back at a committed checkpoint once
                   the host can place the missing workers. Every
                   transition goes checkpoint, re-form, restore.
    elastic_formation_timeout_s -- how long one formation attempt at one
                   size waits for its leases before stepping down.
    elastic_grow_probe_period_s -- below num_workers, the trainer reads
                   the free resources at most this often; <= 0 never grows.
    drain_on_oom_risk -- the reference's preemptive drain on out-of-memory
                   telemetry: True raises NotImplementedError (ROADMAP
                   Queue A item 14, the node agent's telemetry).
    collective_config -- the wire knobs of the gang's collective group: a
                   ``util.collective.CollectiveConfig``, e.g.
                   ``CollectiveConfig(quantize="int8")`` for the ring's
                   block-scaled gradient wire with error feedback, or
                   ``overlap=True`` for the bucketed sync. None: the exact
                   wire.
    """

    num_workers: int = 1
    use_gpu: bool = True
    mesh_axes: Mapping[str, int] = field(default_factory=dict)
    pipeline_stages: int = 1
    microbatches: int = 1
    virtual_stages: int = 1
    slice_topology: Any = None
    resources_per_worker: Mapping[str, float] = field(default_factory=dict)
    min_workers: int | None = None
    elastic_formation_timeout_s: float = 30.0
    elastic_grow_probe_period_s: float = 5.0
    drain_on_oom_risk: bool = False
    collective_config: Any = None

    def worker_resources(self) -> dict[str, float]:
        """One worker's bundle: a CPU, its card under use_gpu (where the
        reference adds TPU chips under use_tpu), and resources_per_worker."""
        resources = {"CPU": 1.0, **{k: float(v) for k, v in self.resources_per_worker.items()}}
        if self.use_gpu and "GPU" not in resources:
            resources["GPU"] = 1.0
        return resources

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None and self.min_workers < self.num_workers

    def factorization(self, world_size: int | None = None) -> dict[str, int]:
        """The (dp, fsdp, tp, pp) this config asks for at ``world_size``
        workers (num_workers by default; an elastic gang may form
        smaller): pp from pipeline_stages (or mesh_axes when that is 1)."""
        pp = int(self.pipeline_stages)
        world = self.num_workers if world_size is None else int(world_size)
        axes = dict(self.mesh_axes) or {"dp": world // pp}
        out = {a: int(axes.get(a, 1)) for a in ("dp", "fsdp", "tp", "pp")}
        if pp > 1:
            out["pp"] = pp
        return out

    def __post_init__(self) -> None:
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.min_workers is not None and not 1 <= self.min_workers <= self.num_workers:
            raise ValueError("min_workers must satisfy 1 <= min_workers <= num_workers")
        if self.drain_on_oom_risk:
            raise NotImplementedError(
                "drain_on_oom_risk needs the node agent's oom_risk telemetry, which the port "
                "does not have yet (ROADMAP Queue A item 14)")
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
    """num_to_keep: retain only the last K persisted checkpoints.
    checkpoint_frequency: Tune saves a trial every this many iterations
    (0: at its end and at its scheduler's decisions)."""

    num_to_keep: int | None = None
    checkpoint_frequency: int = 0

    def __post_init__(self) -> None:
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


@dataclass
class RunConfig:
    """Where results and checkpoints land (a local path) and how failures
    are handled. callbacks: objects whose ``on_result(metrics)`` the
    trainer calls each report round (Tune's also get its trial events);
    stop: {metric: bound}, the run ends at the first round whose metric
    reaches its bound."""

    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1
    callbacks: list[Any] = field(default_factory=list)
    stop: Mapping[str, float] | None = None

    def resolved_storage_path(self) -> str:
        return os.path.expanduser(self.storage_path or "~/ray_tpu_results")
