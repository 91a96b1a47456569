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

Each report carries the rank's StepStats record; ``Result.step_stats``
keeps them by rank (the reference hands them to its flight recorder, whose
driver half waits for ROADMAP item 8b). ``capture_profile`` is the
reference's coordinated step-aligned capture (``util.state.capture_profile``
and the controller's side of it), run through the report round: callable
from another thread while ``fit()`` runs, it arms the selected ranks at the
same upcoming step boundary, gathers each rank's capture from the report
that follows its end and merges them into one Perfetto trace under
``<trial_dir>/profiles/<capture_id>/``.

Left out, each in ROADMAP Queue A item 4 with its reason: multi-host
gangs, elastic step-down and grow, datasets, Tune, preemptive drains of
OOM-flagged ranks, and storage other than a local path.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ray_tpu_torch._private import profile_merge
from ray_tpu_torch._private import profiler as profiler_mod
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.checkpoint import (
    Checkpoint, StorageContext, _atomic_write_json, merge_sharded_checkpoints,
)
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
    each gang's start, formation, first report and end; ``step_stats`` each
    rank's StepStats records, in report order."""

    metrics: dict = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    path: str = ""
    error: Optional[Exception] = None
    metrics_history: list = field(default_factory=list)
    resizes: list = field(default_factory=list)
    attempts: list = field(default_factory=list)
    step_stats: dict = field(default_factory=dict)

    @property
    def best_checkpoint(self) -> list:
        return [self.checkpoint] if self.checkpoint else []


def _run_session(gang_ctx, train_fn: Callable, train_loop_config: dict, experiment_name: str,
                 trial_dir: str, latest_checkpoint: Optional[Checkpoint], mesh_axes: dict,
                 pipeline: dict | None = None, slice_topology: Any = None) -> dict:
    """Runs on every member: the user's loop inside a train session. Under
    pipeline stages, gang rank r is stage r // (world / stages):
    contiguous ranks form one stage's gang. Returns, with ``done``, a
    capture that ended with the loop."""
    if pipeline is not None:
        per_stage = max(1, gang_ctx.world_size // int(pipeline["num_stages"]))
        pipeline = {**pipeline, "stage": gang_ctx.rank // per_stage,
                    "stage_rank": gang_ctx.rank % per_stage}
    ctx = session_mod.TrainContext(
        world_size=gang_ctx.world_size, world_rank=gang_ctx.rank, local_rank=gang_ctx.rank,
        node_id=gang_ctx.node_id, experiment_name=experiment_name, trial_dir=trial_dir,
        train_loop_config=dict(train_loop_config), latest_checkpoint=latest_checkpoint,
        mesh=mesh_axes, collective_group=gang_ctx.group_name, device=str(gang_ctx.device),
        pipeline=pipeline, slice_topology=slice_topology)
    session_mod.init_session(ctx, gang_ctx.channel)
    try:
        train_fn(dict(train_loop_config))
    finally:
        capture = session_mod.shutdown_session()
    return {"done": True, "profile": capture}


@dataclass
class _Capture:
    """One ``capture_profile`` request, from its queueing to its record."""

    capture_id: str
    steps: int
    ranks: list | None
    done: threading.Event = field(default_factory=threading.Event)
    record: dict = field(default_factory=dict)
    # Set when the driver loop arms it:
    start_step: int | None = None
    targets: list = field(default_factory=list)
    deadline: float = 0.0
    aborted: bool = False
    arm_results: dict = field(default_factory=dict)
    captures: dict = field(default_factory=dict)


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
        topology: Any = None,
    ):
        """``topology`` (a ``parallel.topology.SliceTopology``) sets
        ``scaling_config.slice_topology``, as the reference's JaxTrainer's
        does."""
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        if topology is not None:
            self.scaling_config = dataclasses.replace(self.scaling_config,
                                                      slice_topology=topology)
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self._profile_lock = threading.Lock()
        self._profile_queue: list[_Capture] = []
        self._profile_seq = itertools.count()
        self._active: _Capture | None = None

    def capture_profile(self, steps: int = 3, ranks: list | None = None, wait: bool = True,
                        timeout_s: float = 300.0) -> dict:
        """One coordinated, step-aligned profile capture across the gang of
        a running ``fit()`` (callable from another thread): the selected
        ranks (all by default) are armed at the same upcoming step
        boundary, capture ``steps`` steps of device trace, host samples and
        annotation slices, and their captures merge into one Perfetto
        trace. Returns the reference's record (``status``, ``ranks``,
        ``start_step``, ``path``, ``folded_path``, ``hot_phases``,
        ``workers``, ``arm_errors``, ...); ``wait=False`` returns the
        capture id at once, and a wait past ``timeout_s`` a ``timeout``
        error."""
        with self._profile_lock:
            request = _Capture(capture_id=f"prof-{next(self._profile_seq):04d}-manual",
                               steps=max(1, int(steps)),
                               ranks=None if ranks is None else [int(r) for r in ranks])
            self._profile_queue.append(request)
        if not wait:
            return {"status": "ok", "capture_id": request.capture_id}
        if request.done.wait(timeout_s):
            return request.record
        return {"status": "error", "code": "timeout", "capture_id": request.capture_id,
                "error": f"capture did not finish within {timeout_s}s"}

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
                               pipeline=sc.pipeline(attempt=len(result.attempts) - 1),
                               slice_topology=sc.slice_topology)
                result.error = self._drive(gang, storage, result, attempt)
                attempt["ended_by"] = "error" if result.error else "done"
            except (GangDiedError, TrainingFailedError) as exc:
                died = exc
                attempt["ended_by"] = "gang_died"
            finally:
                attempt["end"] = time.time()
                if gang is not None:
                    gang.shutdown()
                self._end_capture(storage)
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
        with self._profile_lock:
            queued, self._profile_queue = self._profile_queue, []
        for request in queued:
            request.record = {"status": "error", "code": "not_running",
                              "capture_id": request.capture_id,
                              "error": "fit() ended before the capture could start"}
            request.done.set()
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
                    if self._active is not None and (body[0] or {}).get("profile"):
                        self._active.captures[rank] = body[0]["profile"]
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
            extras = self._profile_round(reports, storage, result)
            for rank in reports:
                gang.send(rank, ("ack", extras[rank]) if rank in extras else ("ack",))

    # -- profile captures (the reference controller's side) -----------------
    def _profile_round(self, reports: dict, storage: StorageContext, result: Result) -> dict:
        """Reads one round's StepStats and capture replies, ends the active
        capture when every armed rank has sent its capture (aborting the
        ranks still armed past its deadline), and arms the next request.
        Returns what each rank's ack carries."""
        steps = {}
        for rank, report in sorted(reports.items()):
            rec = report.get("step_stats")
            if rec is not None:
                result.step_stats.setdefault(rank, []).append(rec)
                steps[rank] = int(rec["step"])
            profile = report.get("profile") or {}
            if self._active is not None:
                if "arm" in profile:
                    self._active.arm_results[rank] = profile["arm"]
                if "capture" in profile:
                    self._active.captures[rank] = profile["capture"]
        extras: dict[int, dict] = {}
        cap = self._active
        if cap is not None:
            waiting = [r for r in cap.targets if r not in cap.captures
                       and cap.arm_results.get(r, {}).get("status", "ok") == "ok"]
            if not waiting:
                self._end_capture(storage)
            elif time.monotonic() > cap.deadline and not cap.aborted:
                # Ranks still armed or capturing past the deadline (a step
                # stream that stalled): abort them, so their next report
                # brings a partial capture instead of none.
                cap.aborted = True
                for rank in waiting:
                    if rank in reports:
                        extras[rank] = {"profile": {"action": "abort"}}
        if self._active is None:
            with self._profile_lock:
                cap = self._profile_queue.pop(0) if self._profile_queue else None
            if cap is not None:
                self._active = cap
                cap.targets = [r for r in sorted(reports)
                               if cap.ranks is None or r in cap.ranks]
                if not cap.targets:
                    self._end_capture(storage, code="no_train_workers")
                    return extras
                # The SAME upcoming boundary for every rank: past the
                # furthest rank's current step, plus the reference's slack.
                cap.start_step = (max(steps.values()) + 2) if steps else 0
                max_s = profiler_mod.knob_float("MAX_S", 60.0)
                cap.deadline = time.monotonic() + max_s + 15.0
                payload = {"action": "arm", "capture_id": cap.capture_id,
                           "start_step": cap.start_step, "steps": cap.steps, "max_s": max_s,
                           "session_dir": storage.trial_dir}
                for rank in cap.targets:
                    extras[rank] = {"profile": payload}
        return extras

    def _end_capture(self, storage: StorageContext, code: str | None = None) -> None:
        """Merges the active capture's per-rank captures into
        ``merged_trace.json`` and ``merged_folded.json`` and completes its
        request with the reference's record (``code``: an error record)."""
        cap, self._active = self._active, None
        if cap is None:
            return
        rec: dict = {"capture_id": cap.capture_id, "ts": time.time(), "reason": "manual",
                     "steps": cap.steps, "requested_ranks": cap.ranks}
        if code is not None:
            rec.update(status="error", code=code)
            cap.record = rec
            cap.done.set()
            return
        try:
            arm_errors = {r: res for r, res in cap.arm_results.items()
                          if res.get("status") != "ok"}
            captures = [c for _, c in sorted(cap.captures.items()) if c.get("status") == "ok"]
            out_dir = os.path.join(storage.trial_dir, "profiles", cap.capture_id)
            os.makedirs(out_dir, exist_ok=True)
            trace = profile_merge.merge_captures(
                captures, cap.capture_id,
                meta={"reason": "manual", "start_step": cap.start_step})
            folded = profile_merge.merge_folded(captures)
            trace_path = os.path.join(out_dir, "merged_trace.json")
            folded_path = os.path.join(out_dir, "merged_folded.json")
            _atomic_write_json(trace_path, trace)
            _atomic_write_json(folded_path, folded)
            hot = {}
            for c in captures:
                if c.get("rank") is None:
                    continue
                phase, frac = profile_merge.hot_phase(c.get("phase_totals") or {})
                if phase is not None:
                    hot[str(c["rank"])] = {"phase": phase, "frac": round(frac, 4)}
            rec.update(
                status="ok" if captures and not arm_errors else "partial",
                ranks=trace["metadata"]["ranks"], start_step=cap.start_step,
                path=trace_path, folded_path=folded_path, hot_phases=hot,
                workers=len(captures),
                arm_errors={r: res.get("code") or res.get("error")
                            for r, res in arm_errors.items()} or None,
                trace_ids=trace["metadata"]["trace_ids"])
            if not captures:
                rec["status"] = "error"
                rec["code"] = "no_captures"
        except Exception as exc:  # the request gets a typed record; fit() goes on
            logger.exception("profile capture %s failed", cap.capture_id)
            rec.update(status="error", code="exception", error=str(exc))
        cap.record = rec
        cap.done.set()
