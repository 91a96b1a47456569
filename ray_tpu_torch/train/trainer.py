"""TorchTrainer: ``train_loop_per_worker`` on a gang of worker processes,
with lockstep report rounds, committed checkpoints and restart of the
whole gang from the latest one when a member dies.

The counterpart of ray_tpu's ``JaxTrainer`` / ``DataParallelTrainer``
(``train/jax_trainer.py``) and of the parts of its ``BackendExecutor``
the loop needs (``train/_internal/backend_executor.py``: starting the
sessions, polling a round, merging the ranks' checkpoint directories), on
the port's single-host gang (``util.gang``) in place of the runtime's
placement groups and actors:

    def train_loop(config):
        setup = setup_sharded_training(init_fn, make_optimizer)  # the session's mesh
        ...
        report({"loss": loss}, checkpoint=save_sharded_state(params, opt))

    result = TorchTrainer(train_loop, scaling_config=ScalingConfig(num_workers=2),
                          run_config=RunConfig(storage_path=..., failure_config=
                                               FailureConfig(max_failures=1))).fit()

The driver loop keeps the reference's semantics: every rank reports once a
round; a reported checkpoint is merged across ranks and committed through
the two-phase protocol (``train.checkpoint.StorageContext``), with
``num_to_keep`` honoured; a member's death ends the gang, which restarts
from the latest committed checkpoint up to ``FailureConfig.max_failures``
times; an exception in the user's loop ends the run with that error, as
the reference's does; ``resume_from_checkpoint`` starts from a given one.

Left out, each in ROADMAP Queue A item 4 with its reason: multi-host
gangs, elastic step-down and grow, datasets, Tune, preemptive drains of
OOM-flagged ranks, and storage other than a local path.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.checkpoint import Checkpoint, StorageContext, merge_sharded_checkpoints
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.util.gang import GangDiedError, WorkerError, WorkerGang

logger = logging.getLogger(__name__)

# Longest wait for one rank's report before the round counts as stalled.
ROUND_TIMEOUT_S = 1800.0


class TrainingFailedError(RuntimeError):
    """The gang stalled: a rank sent nothing within the round's time."""


@dataclass
class Result:
    """What fit() returns, as ray_tpu's ``Result``. ``resizes`` holds every
    restart of the gang ({"reason": "gang_died", "from": k, "to": None,
    "error": ...}); ``attempts`` the wall-clock times (``time.time()``) of
    each gang's start, formation, first report and end."""

    metrics: dict = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    path: str = ""
    error: Optional[Exception] = None
    metrics_history: list = field(default_factory=list)
    resizes: list = field(default_factory=list)
    attempts: list = field(default_factory=list)

    @property
    def best_checkpoint(self) -> list:
        return [self.checkpoint] if self.checkpoint else []


def _run_session(gang_ctx, train_fn: Callable, train_loop_config: dict, experiment_name: str,
                 trial_dir: str, latest_checkpoint: Optional[Checkpoint], mesh_axes: dict,
                 pipeline: dict | None = None) -> dict:
    """Runs on every member: the user's loop inside a train session. Under
    pipeline stages, gang rank r is stage r // (world / stages):
    contiguous ranks form one stage's gang."""
    if pipeline is not None:
        per_stage = max(1, gang_ctx.world_size // int(pipeline["num_stages"]))
        pipeline = {**pipeline, "stage": gang_ctx.rank // per_stage,
                    "stage_rank": gang_ctx.rank % per_stage}
    ctx = session_mod.TrainContext(
        world_size=gang_ctx.world_size, world_rank=gang_ctx.rank, local_rank=gang_ctx.rank,
        node_id=gang_ctx.node_id, experiment_name=experiment_name, trial_dir=trial_dir,
        train_loop_config=dict(train_loop_config), latest_checkpoint=latest_checkpoint,
        mesh=mesh_axes, collective_group=gang_ctx.group_name, device=str(gang_ctx.device),
        pipeline=pipeline)
    session_mod.init_session(ctx, gang_ctx.channel)
    try:
        train_fn(dict(train_loop_config))
    finally:
        session_mod.shutdown_session()
    return {"done": True}


class TorchTrainer:
    """N workers x train_loop_per_worker(config), lockstep report rounds."""

    def __init__(
        self,
        train_loop_per_worker: Callable[[dict], Any],
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        resume_from_checkpoint: Checkpoint | None = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def _experiment_name(self) -> str:
        return self.run_config.name or type(self).__name__.lower()

    def fit(self) -> Result:
        run_cfg, sc = self.run_config, self.scaling_config
        storage = StorageContext(run_cfg.resolved_storage_path(), self._experiment_name(),
                                 checkpoint_config=run_cfg.checkpoint_config)
        latest = self.resume_from_checkpoint or storage.latest_checkpoint()
        failures = 0
        result = Result(path=storage.trial_dir)
        while True:
            attempt = {"start": time.time()}
            result.attempts.append(attempt)
            gang, died = None, None
            try:
                gang = WorkerGang(sc.num_workers, use_gpu=sc.use_gpu)
                attempt["formed"] = time.time()
                gang.run_async(_run_session, train_fn=self.train_loop_per_worker,
                               train_loop_config=self.train_loop_config,
                               experiment_name=self._experiment_name(),
                               trial_dir=storage.trial_dir, latest_checkpoint=latest,
                               mesh_axes=dict(sc.mesh_axes),
                               # The attempt fences a re-formed gang's
                               # traffic from a dead one's.
                               pipeline=sc.pipeline(attempt=len(result.attempts) - 1))
                result.error = self._drive(gang, storage, result, attempt)
                attempt["ended_by"] = "error" if result.error else "done"
            except (GangDiedError, TrainingFailedError) as exc:
                died = exc
                attempt["ended_by"] = "gang_died"
            finally:
                attempt["end"] = time.time()
                if gang is not None:
                    gang.shutdown()
            if died is None:
                break
            result.error = died
            max_failures = run_cfg.failure_config.max_failures
            if 0 <= max_failures <= failures:
                break
            failures += 1
            result.resizes.append({"reason": "gang_died", "from": sc.num_workers, "to": None,
                                   "error": str(died)})
            latest = storage.latest_checkpoint()
            result.error = None
        result.checkpoint = storage.latest_checkpoint()
        return result

    def _drive(self, gang: WorkerGang, storage: StorageContext, result: Result,
               attempt: dict) -> Exception | None:
        """Rounds until every rank is done or a rank's loop raises
        (returned). A member's death raises GangDiedError."""
        done: set[int] = set()
        while True:
            reports: dict[int, dict] = {}
            pending = [r for r in range(gang.num_workers) if r not in done]
            while pending:
                try:
                    rank, (kind, *body) = gang.recv_any(pending, timeout=ROUND_TIMEOUT_S)
                except TimeoutError as exc:
                    raise TrainingFailedError(f"train workers stalled: {exc}") from exc
                pending.remove(rank)
                if kind == "error":
                    dead = gang.died(within=2.0)
                    if dead:  # the error echoes a member's death: the gang died
                        raise GangDiedError(f"gang members {dead} died; rank {rank} then "
                                            f"raised {body[0]}")
                    return WorkerError(rank, body[0], body[1])
                if kind == "result":
                    done.add(rank)
                else:
                    reports[rank] = body[0]
            if len(done) == gang.num_workers:
                return None
            if not reports:
                continue
            attempt.setdefault("first_report", time.time())
            metrics = dict(reports[min(reports)]["metrics"])
            metrics.setdefault("factorization", self.scaling_config.factorization())
            ckpt = merge_sharded_checkpoints(
                [reports.get(rank, {}).get("checkpoint") for rank in range(gang.num_workers)])
            if ckpt is not None:
                try:
                    metrics["checkpoint_path"] = storage.persist(ckpt, metrics).path
                except IOError as exc:
                    # A torn save: skip the commit and keep training; recovery
                    # falls back to the previous committed checkpoint.
                    logger.warning("skipping uncommittable checkpoint: %s", exc)
            result.metrics = metrics
            result.metrics_history.append(metrics)
            for rank in reports:
                gang.send(rank, ("ack",))
