"""TorchTrainer: ``train_loop_per_worker`` on a gang of runtime actors,
with lockstep report rounds, committed checkpoints and restart of the
whole gang from the latest one when a member dies.

The counterpart of ray_tpu's ``JaxTrainer`` / ``DataParallelTrainer``
(``train/jax_trainer.py``) and of the parts of its ``BackendExecutor``
the loop needs (``train/_internal/backend_executor.py``: starting the
sessions, polling a round, merging the ranks' checkpoint directories), on
the port's gang (``util.gang``: one actor a rank in a placement group).
Like the reference, ``fit()`` needs ``ray_tpu_torch.init()`` first. Each
member runs the user's loop on a thread of its session
(``_start_session_fn``); a round is one actor call a rank
(``_poll_round``) that returns the rank's report, and the next round's
call carries the trainer's ``ack`` (or a ``stop``) back to it:

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

Each round's metrics go to every ``RunConfig.callbacks`` entry's
``on_result``, and a round whose metric reaches its ``RunConfig.stop``
bound ends the run, as the reference's ``_drive`` does; the ranks then
get ``stop`` in place of their ack. A callback that raises (Tune's
``report`` when Tune stops the trial) ends the run with its exception,
after the same ``stop``. A ``TorchTrainer`` pickles (stdlib) without its
capture state: Tune sends one to its trial's actor.

Each report carries the rank's StepStats record; ``Result.step_stats``
keeps them by rank, and the driver's flight recorder
(``step_stats.FlightRecorder``) folds each round's into rolling tokens/s,
MFU and a straggler scan (both put into the round's metrics, as the
reference's are), queues one capture when a rank keeps straggling, and
cuts the run's wall clock into ``Result.goodput``'s buckets: restart
(formation and backoff), stalled (work lost to a death), checkpoint and
productive. ``capture_profile`` is the
reference's coordinated step-aligned capture (``util.state.capture_profile``
and the controller's side of it), run through the report round: callable
from another thread while ``fit()`` runs, it arms the selected ranks at the
same upcoming step boundary, gathers each rank's capture from the report
that follows its end and merges them into one Perfetto trace under
``<trial_dir>/profiles/<capture_id>/``.

Elasticity, with ``ScalingConfig.min_workers``: the gang forms at the
largest size from ``num_workers`` down to ``min_workers`` whose placement
group places within ``elastic_formation_timeout_s``; a
gang death re-forms it (full-jitter backoff between restarts, reset once
a gang forms); and at a round whose checkpoint committed, a probe of the
free resources (at most every ``elastic_grow_probe_period_s``) that covers
every missing worker ends the gang voluntarily, neither counted against
``max_failures`` nor backed off, and re-forms it at ``num_workers``. Every
transition goes checkpoint, re-form, restore: each gang restores the
latest committed checkpoint at its own world size, which
``TrainContext.world_size`` and the round's ``factorization`` report.
``Result.resizes`` lists the transitions as the reference does.

Datasets, as the reference's ``datasets=``: once a gang has formed, each
``ray_tpu_torch.data.Dataset`` is split across the size it formed at
(``streaming_split``; a list is strided and anything else replicated), and
each rank reads its shard through ``get_dataset_shard(name)``. Every report
carries the rank's shard positions, and the round's checkpoint commits them
as ``ingest.json`` (``{"world_size", "datasets": {name: [state per rank]}}``);
a gang that restarts or resizes re-splits the rows no rank had consumed at
that commit across its own size. So a death, a step-down or a grow-back
delivers every row, replaying at most the rows read since the last
committed round.

The gang's collective group is the reference's: ``TorchTrainer(backend=)``
names it, as ``DataParallelTrainer(backend=)`` does. The default (None)
stays the process group's own (NCCL under ``use_gpu``, gloo on the CPU);
"ring" forms the host-memory ring (``util.collective.RingGroup``), whose
members may share a card, and the gang's group carries
``ScalingConfig.collective_config`` either way, so the gradient syncs
(``train.torch_utils``) honour its quantized wire and its overlap.

Left out, each in ROADMAP with its reason: multi-host gangs and storage
other than a local path (Queue A item 4), locality-aware splits and
ingest across hosts, preemptive drains of ranks on out-of-memory telemetry
and the recorder's push to a workload store (item 14).
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

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch._private import profile_merge
from ray_tpu_torch._private import profiler as profiler_mod
from ray_tpu_torch._private import worker
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.checkpoint import (
    Checkpoint, StorageContext, _atomic_write_json, merge_sharded_checkpoints,
)
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.step_stats import FlightRecorder
from ray_tpu_torch.util.backoff import Backoff
from ray_tpu_torch.util.gang import _DEATHS, GangDiedError, WorkerError, WorkerGang

logger = logging.getLogger(__name__)

# Longest wait for one rank's report before the round counts as stalled.
ROUND_TIMEOUT_S = 1800.0
# How long one poll of a member's session waits for its next report.
POLL_S = 1.0
# How often a round with no answer looks for a member whose process ended.
DEATH_CHECK_S = 0.5
# How long the members may take to start their sessions.
START_SESSION_TIMEOUT_S = 300.0


class TrainingFailedError(RuntimeError):
    """The gang stalled (a rank sent nothing within the round's time), or
    could not form at any size."""


@dataclass
class Result:
    """What fit() returns, as ray_tpu's ``Result``. ``resizes`` holds every
    world-size transition: {"reason": "gang_died", "from": k, "to": None,
    "error": ...} for a death (k the gang that died), {"reason": "grow",
    "from": k, "to": num_workers} for a grow-back; ``attempts`` each gang's
    wall-clock times (``time.time()``: start, formation, first report, end,
    and ``spawned``, when the gang that formed started its members), the
    size it formed at (``world_size``), each formation attempt
    (``formations``: size, seconds, whether it formed) and the members'
    ``rank_infos`` (``members``, with the times each entered and joined its
    groups); ``step_stats`` each rank's StepStats records, in report order;
    ``goodput`` the flight recorder's
    buckets (``wall_s``, ``productive_s``, ``checkpoint_s``, ``restart_s``,
    ``stalled_s``, ``goodput_fraction``)."""

    metrics: dict = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    path: str = ""
    error: Optional[Exception] = None
    metrics_history: list = field(default_factory=list)
    resizes: list = field(default_factory=list)
    attempts: list = field(default_factory=list)
    step_stats: dict = field(default_factory=dict)
    goodput: dict = field(default_factory=dict)

    @property
    def best_checkpoint(self) -> list:
        return [self.checkpoint] if self.checkpoint else []


def _split_datasets(datasets: dict, num_workers: int, ingest: dict | None = None) -> list[dict]:
    """Per-rank dataset shards (ray_tpu's ``jax_trainer._split_datasets``).
    A Dataset splits through ``streaming_split``; a list or tuple is
    strided; anything else is replicated. ``ingest`` is the record stamped
    into the checkpoint being resumed ({"world_size": W, "datasets": {name:
    [state, ...]}}): a Dataset's shards then resume mid-epoch, the rows no
    rank had consumed re-split across ``num_workers`` (which may differ
    from W). Striding is positionless and replays the epoch from its
    start."""
    shards: list[dict] = [dict() for _ in range(num_workers)]
    per_ds_states = (ingest or {}).get("datasets", {})
    for name, ds in (datasets or {}).items():
        if hasattr(ds, "streaming_split"):
            resume_from = None
            if name in per_ds_states:
                resume_from = {"world_size": (ingest or {}).get("world_size", 0),
                               "per_rank": per_ds_states[name]}
            for rank, it in enumerate(ds.streaming_split(num_workers, resume_from=resume_from)):
                shards[rank][name] = it
        elif isinstance(ds, (list, tuple)):
            for rank in range(num_workers):
                shards[rank][name] = ds[rank::num_workers]
        else:
            for rank in range(num_workers):
                shards[rank][name] = ds
    return shards


def _ingest_record(world_size: int, reports: dict) -> dict | None:
    """The round's ingest record: each rank's shard states by dataset name
    (ray_tpu's ``jax_trainer`` commit), or None when no rank sent one."""
    states = [reports.get(rank, {}).get("ingest") for rank in range(world_size)]
    if not any(states):
        return None
    names = sorted({n for s in states if s for n in s})
    return {"world_size": world_size,
            "datasets": {name: [(s or {}).get(name) for s in states] for name in names}}


def _start_session_fn(gang_ctx, dataset_shards: dict, train_fn: Callable,
                      train_loop_config: dict, experiment_name: str, trial_dir: str,
                      latest_checkpoint: Optional[Checkpoint], mesh_axes: dict,
                      pipeline: dict | None = None, slice_topology: Any = None) -> bool:
    """Runs on every member: starts the user's loop inside a train session,
    on a thread of the member, and returns. Under pipeline stages, gang
    rank r is stage r // (world / stages): contiguous ranks form one
    stage's gang."""
    if pipeline is not None:
        per_stage = max(1, gang_ctx.world_size // int(pipeline["num_stages"]))
        pipeline = {**pipeline, "stage": gang_ctx.rank // per_stage,
                    "stage_rank": gang_ctx.rank % per_stage}
    ctx = session_mod.TrainContext(
        world_size=gang_ctx.world_size, world_rank=gang_ctx.rank, local_rank=gang_ctx.rank,
        node_id=gang_ctx.node_id, experiment_name=experiment_name, trial_dir=trial_dir,
        train_loop_config=dict(train_loop_config), latest_checkpoint=latest_checkpoint,
        mesh=mesh_axes, collective_group=gang_ctx.group_name, device=str(gang_ctx.device),
        pipeline=pipeline, slice_topology=slice_topology, dataset_shards=dict(dataset_shards))
    session = session_mod.init_session(ctx)
    gang_ctx.state["session"] = session
    session.start(lambda: train_fn(dict(train_loop_config)))
    return True


def _poll_fn(gang_ctx, reply: tuple | None, poll_timeout: float) -> dict | None:
    """One poll of a member's session: hands its loop ``reply`` (the answer
    to its last report) and returns its next report or end, or None."""
    return gang_ctx.state["session"].next_result(reply, timeout=poll_timeout)


@dataclass
class _Capture:
    """One ``capture_profile`` request, from its queueing to its record."""

    capture_id: str
    steps: int
    ranks: list | None
    reason: str = "manual"
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
        datasets: dict | None = None,
        topology: Any = None,
        backend: str | None = None,
    ):
        """``topology`` (a ``parallel.topology.SliceTopology``) sets
        ``scaling_config.slice_topology``, as the reference's JaxTrainer's
        does. ``datasets`` maps names to what each rank reads through
        ``get_dataset_shard(name)``. ``backend``: the gang's collective
        group, None (the process group's own) or "ring"."""
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        if topology is not None:
            self.scaling_config = dataclasses.replace(self.scaling_config,
                                                      slice_topology=topology)
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = dict(datasets or {})
        if backend not in (None, "ring"):
            raise ValueError(f"backend {backend!r}: None (the process group's own) or 'ring'")
        self.backend = backend
        self._init_captures()

    def _init_captures(self) -> None:
        self._profile_lock = threading.Lock()
        self._profile_queue: list[_Capture] = []
        self._profile_seq = itertools.count()
        self._active: _Capture | None = None

    _CAPTURE_STATE = ("_profile_lock", "_profile_queue", "_profile_seq", "_active")

    def __getstate__(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if k not in self._CAPTURE_STATE}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._init_captures()

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
        request = self._queue_capture(steps, ranks)
        if not wait:
            return {"status": "ok", "capture_id": request.capture_id}
        if request.done.wait(timeout_s):
            return request.record
        return {"status": "error", "code": "timeout", "capture_id": request.capture_id,
                "error": f"capture did not finish within {timeout_s}s"}

    def _queue_capture(self, steps: int, ranks: list | None, reason: str = "manual") -> _Capture:
        """Queues one capture request; the driver loop arms it at its next
        round. The flight recorder's auto-capture comes here too, where the
        reference's calls its controller."""
        with self._profile_lock:
            request = _Capture(capture_id=f"prof-{next(self._profile_seq):04d}-{reason}",
                               steps=max(1, int(steps)),
                               ranks=None if ranks is None else [int(r) for r in ranks],
                               reason=reason)
            self._profile_queue.append(request)
        return request

    def _experiment_name(self) -> str:
        return self.run_config.name or type(self).__name__.lower()

    def fit(self) -> Result:
        # The gang runs on the runtime: without init() this raises its error.
        worker.get_global_context()
        run_cfg, sc = self.run_config, self.scaling_config
        storage = StorageContext(run_cfg.resolved_storage_path(), self._experiment_name(),
                                 checkpoint_config=run_cfg.checkpoint_config)
        latest = self.resume_from_checkpoint or storage.latest_checkpoint()
        failures = 0
        result = Result(path=storage.trial_dir)
        # Full-jitter restart backoff: a death that killed the gang often
        # killed its neighbours' too, and a fixed schedule re-forms them all
        # at once.
        backoff = Backoff(initial_backoff_s=0.1, max_backoff_s=5.0)
        recorder = FlightRecorder(self._experiment_name(), request_capture=self._queue_capture)
        while True:
            attempt = {"start": time.time()}
            result.attempts.append(attempt)
            gang, died, resize = None, None, None
            try:
                form_t0 = time.monotonic()
                try:
                    gang = self._form_gang(attempt.setdefault("formations", []))
                    attempt["formed"], attempt["world_size"] = time.time(), gang.num_workers
                    attempt["spawned"], attempt["members"] = gang.spawned_at, gang.rank_infos()
                    # Split AFTER formation, at the size that formed: a
                    # resumed gang re-splits the rows left at the commit.
                    shards = _split_datasets(
                        self.datasets, gang.num_workers,
                        ingest=storage.latest_ingest() if latest is not None else None)
                    gang.get(gang.run_async(
                        _start_session_fn, per_rank_args=[(s,) for s in shards],
                        train_fn=self.train_loop_per_worker,
                        train_loop_config=self.train_loop_config,
                        experiment_name=self._experiment_name(),
                        trial_dir=storage.trial_dir, latest_checkpoint=latest,
                        mesh_axes=dict(sc.mesh_axes),
                        # The attempt fences a re-formed gang's traffic
                        # from a dead one's.
                        pipeline=sc.pipeline(attempt=len(result.attempts) - 1),
                        slice_topology=sc.slice_topology), timeout=START_SESSION_TIMEOUT_S)
                finally:
                    # Formation is restart time, whether it formed or not.
                    recorder.note_restart(time.monotonic() - form_t0)
                recorder.note_progress()
                backoff.reset()
                result.error, resize = self._drive(gang, storage, result, attempt, recorder)
                attempt["ended_by"] = ("error" if result.error else
                                       resize["reason"] if resize else "done")
            except (GangDiedError, TrainingFailedError, TimeoutError) as exc:
                died = exc
                attempt["ended_by"] = "gang_died"
            except WorkerError as exc:  # the session did not start: the run's error
                result.error = exc
                attempt["ended_by"] = "error"
            finally:
                attempt["end"] = time.time()
                prev_size = gang.num_workers if gang is not None else None
                if gang is not None:
                    gang.shutdown()
                self._end_capture(storage)
            if resize is not None:
                # A voluntary transition at a committed checkpoint: not a
                # failure, not counted against max_failures, no backoff.
                result.resizes.append(resize)
                latest = storage.latest_checkpoint()
                continue
            if died is None:
                break
            # The wall clock since the last committed round is lost work
            # and detection time: the stalled bucket.
            recorder.note_stalled_since_progress()
            result.error = died
            max_failures = run_cfg.failure_config.max_failures
            if 0 <= max_failures <= failures:
                break
            failures += 1
            result.resizes.append({"reason": "gang_died", "from": prev_size, "to": None,
                                   "error": str(died)})
            latest = storage.latest_checkpoint()
            result.error = None
            sleep_t0 = time.monotonic()
            backoff.sleep()
            recorder.note_restart(time.monotonic() - sleep_t0)
        result.checkpoint = storage.latest_checkpoint()
        result.goodput = recorder.finalize()
        with self._profile_lock:
            queued, self._profile_queue = self._profile_queue, []
        for request in queued:
            request.record = {"status": "error", "code": "not_running",
                              "capture_id": request.capture_id,
                              "error": "fit() ended before the capture could start"}
            request.done.set()
        return result

    def _form_gang(self, formations: list) -> WorkerGang:
        """The gang at num_workers or, when elastic, at the largest size
        down to min_workers that forms: one attempt a size, each waiting up
        to elastic_formation_timeout_s for its placement group. A fixed-size
        config makes one attempt. Each attempt's size, seconds and outcome
        go to ``formations``."""
        sc = self.scaling_config
        bundle = sc.worker_resources()
        sizes = range(sc.num_workers, sc.min_workers - 1, -1) if sc.elastic else [sc.num_workers]
        # A fixed-size gang waits for its group as long as a gang does.
        wait = {"ready_timeout": sc.elastic_formation_timeout_s} if sc.elastic else {}
        last_exc: Exception | None = None
        for size in sizes:
            t0 = time.monotonic()
            try:
                gang = WorkerGang(size, use_gpu=sc.use_gpu, resources_per_worker=bundle,
                                  backend=self.backend,
                                  collective_config=sc.collective_config, **wait)
            except (exceptions.PlacementGroupUnschedulableError, GangDiedError) as exc:
                formations.append({"world_size": size, "seconds": time.monotonic() - t0,
                                   "formed": False, "error": str(exc)})
                if not sc.elastic:
                    raise
                last_exc = exc
                continue
            formations.append({"world_size": size, "seconds": time.monotonic() - t0,
                               "formed": True})
            if size < sc.num_workers:
                print(f"[train] elastic step-down: formed gang at world_size={size} "
                      f"(target {sc.num_workers})", flush=True)
            return gang
        raise TrainingFailedError(f"could not form a gang at any size in "
                                  f"[{sc.min_workers}, {sc.num_workers}]: {last_exc}")

    def _want_grow(self, gang: WorkerGang, state: dict) -> bool:
        """The grow-back probe (the reference's): True when the gang runs
        below num_workers and the cluster's free resources
        (``ray_tpu_torch.available_resources()``) cover every missing
        worker's bundle. Read at most every elastic_grow_probe_period_s;
        best effort (a re-formed gang steps down again if the capacity went
        meanwhile)."""
        sc = self.scaling_config
        if not sc.elastic or sc.elastic_grow_probe_period_s <= 0:
            return False
        missing = sc.num_workers - gang.num_workers
        if missing <= 0:
            return False
        now = time.monotonic()
        if now - state.get("last_probe", 0.0) < sc.elastic_grow_probe_period_s:
            return False
        state["last_probe"] = now
        avail = ray_tpu_torch.available_resources()
        return all(avail.get(key, 0.0) >= amount * missing
                   for key, amount in sc.worker_resources().items())

    def _poll_round(self, gang: WorkerGang, ranks: list, replies: dict) -> dict:
        """One result from each of ``ranks`` (the reference's
        ``BackendExecutor.poll_round``): a report, or the end of its loop.
        Each rank's first poll carries ``replies[rank]``, the answer to its
        last report. Returns early on a rank's error (a peer blocked on the
        failed rank would never report). A member's death raises
        GangDiedError; no result within ROUND_TIMEOUT_S TrainingFailedError."""
        deadline = time.monotonic() + ROUND_TIMEOUT_S

        def poll(rank, reply=None):
            return gang.members[rank].run.remote(_poll_fn, (reply, POLL_S), {})

        refs = {rank: poll(rank, replies.get(rank)) for rank in ranks}
        results: dict[int, dict] = {}
        while refs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TrainingFailedError(f"train workers stalled: ranks {sorted(refs)} did "
                                          f"not report within {ROUND_TIMEOUT_S} s")
            ready, _ = ray_tpu_torch.wait(list(refs.values()), num_returns=1,
                                          timeout=min(left, DEATH_CHECK_S))
            if not ready:
                # A call to a dead member waits for the runtime's record of
                # the death; its process's end shows at once.
                dead = gang.died()
                if dead:
                    raise GangDiedError(f"gang members {dead} died during training")
                continue
            for rank in [r for r, ref in refs.items() if ref in ready]:
                try:
                    item = ray_tpu_torch.get(refs.pop(rank), timeout=0)
                except _DEATHS as exc:
                    raise GangDiedError(f"gang member rank={rank} died during training: "
                                        f"{exc}") from exc
                if item is None:
                    refs[rank] = poll(rank)
                    continue
                results[rank] = item
                if "error" in item:
                    return results
        return results

    def _answer(self, gang: WorkerGang, replies: dict) -> None:
        """Hands each rank its answer now, where no next poll would carry it
        (a ``stop``)."""
        refs = [gang.members[rank].run.remote(_poll_fn, (reply, 0.0), {})
                for rank, reply in replies.items()]
        try:
            ray_tpu_torch.get(refs, timeout=60)
        except (exceptions.RayTpuError, TimeoutError):
            pass  # a member gone or wedged: the gang's shutdown kills it

    def _drive(self, gang: WorkerGang, storage: StorageContext, result: Result,
               attempt: dict, recorder: FlightRecorder) -> tuple:
        """Rounds until every rank is done, a rank's loop raises, a stop
        bound is met, or a committed round finds room to grow. Returns
        (the loop's error or None, a voluntary resize or None). A member's
        death raises GangDiedError."""
        done: set[int] = set()
        probe_state: dict = {}
        replies: dict[int, tuple] = {}
        while True:
            reports: dict[int, dict] = {}
            results = self._poll_round(
                gang, [r for r in range(gang.num_workers) if r not in done], replies)
            replies = {}
            for rank, item in sorted(results.items()):
                if "error" in item:
                    dead = gang.died(within=2.0)
                    if dead:  # the error echoes a member's death: the gang died
                        raise GangDiedError(f"gang members {dead} died; rank {rank} then "
                                            f"raised {item['error']}")
                    return WorkerError(rank, item["error"], item["traceback"]), None
                if item.get("done"):
                    done.add(rank)
                    if self._active is not None and item.get("profile"):
                        self._active.captures[rank] = item["profile"]
                else:
                    reports[rank] = item
            if len(done) == gang.num_workers:
                return None, None
            if not reports:
                continue
            attempt.setdefault("first_report", time.time())
            metrics = dict(reports[min(reports)]["metrics"])
            summary = recorder.on_round([reports[rank] for rank in sorted(reports)])
            if summary:
                metrics.setdefault("tokens_per_s", summary["tokens_per_s"])
                if summary.get("mfu") is not None:
                    metrics.setdefault("mfu", summary["mfu"])
                if recorder.stragglers:
                    ranks = [s["rank"] for s in recorder.stragglers]
                    metrics["stragglers"] = ranks
                    if probe_state.get("stragglers_logged") != ranks:
                        probe_state["stragglers_logged"] = ranks
                        logger.warning("straggling ranks detected: %s", recorder.stragglers)
            # The factorization of the gang that formed, which an elastic
            # gang may have formed below num_workers.
            metrics.setdefault("factorization",
                               self.scaling_config.factorization(gang.num_workers))
            ckpt = merge_sharded_checkpoints(
                [reports.get(rank, {}).get("checkpoint") for rank in range(gang.num_workers)])
            committed = False
            if ckpt is not None:
                persist_t0 = time.monotonic()
                try:
                    metrics["checkpoint_path"] = storage.persist(
                        ckpt, metrics, ingest=_ingest_record(gang.num_workers, reports)).path
                    committed = True
                except IOError as exc:
                    # A torn save: skip the commit and keep training; recovery
                    # falls back to the previous committed checkpoint.
                    logger.warning("skipping uncommittable checkpoint: %s", exc)
                finally:
                    # The commit is checkpoint time, committed or torn.
                    recorder.note_checkpoint(time.monotonic() - persist_t0)
            result.metrics = metrics
            result.metrics_history.append(metrics)
            extras = self._profile_round(reports, storage, result)
            try:
                for cb in self.run_config.callbacks:
                    handler = getattr(cb, "on_result", None)
                    if handler:
                        handler(metrics)
            except BaseException:
                # Stop the ranks waiting on this round, so that their loops
                # end before the gang's shutdown kills them.
                self._answer(gang, {rank: ("stop",) for rank in reports})
                raise
            if any(key in metrics and metrics[key] >= bound
                   for key, bound in (self.run_config.stop or {}).items()):
                self._answer(gang, {rank: ("stop",) for rank in reports})
                return None, None
            # A committed checkpoint is the only safe boundary for a
            # voluntary transition: nothing since it is lost.
            if committed and self._want_grow(gang, probe_state):
                self._answer(gang, {rank: ("stop",) for rank in reports})
                return None, {"reason": "grow", "from": gang.num_workers,
                              "to": self.scaling_config.num_workers}
            # The next round's polls carry the acks.
            replies = {rank: ("ack", extras[rank]) if rank in extras else ("ack",)
                       for rank in reports}

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
        rec: dict = {"capture_id": cap.capture_id, "ts": time.time(), "reason": cap.reason,
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
                meta={"reason": cap.reason, "start_step": cap.start_step})
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
