"""WorkerGang: an SPMD group of runtime actors, one a device.

Port of ray_tpu's ``util/gang.py`` (``GangContext``, ``_GangMember``,
``WorkerGang``). A gang is one placement group with a bundle a member
(``resources_per_worker``, a CPU by default, and a card under ``use_gpu``)
and one ``_GangMember`` actor a bundle, scheduled into it with
``PlacementGroupSchedulingStrategy``. The gang waits up to
``ready_timeout`` for the group to place, as the reference's ``pg.ready``
does, and removes the group when it does not (the controller parks an
infeasible group rather than failing it, so a group the host can never
hold fails at its timeout too); the error is the runtime's
``PlacementGroupUnschedulableError``.

Each member sets ``env_vars`` and calls ``torch.distributed.
init_process_group`` where the reference calls ``jax.distributed.
initialize`` (NCCL on a card, gloo otherwise, at ``MASTER_PORT``, a free
port of this host; a port another process takes before rank 0 binds it
starts the gang again, in a new group, on another), then forms its collective group
(``util.collective``). A member under ``use_gpu`` runs on the card its
lease gave it (the node agent's ``CUDA_VISIBLE_DEVICES``, so ``cuda:0``
in the member) and raises when it sees none. ``backend="ring"`` and
``collective_config`` are the reference's: the members join a gloo
process group, whose ``TCPStore`` holds the ring's addresses, and form a
``RingGroup`` carrying the config; they make no NCCL communicator, so two
members may share one card (a bundle of ``{"GPU": 0.5}`` each), which NCCL
cannot do. A gang of one member may take a share of a card on either
backend (Tune's trainer trials share one card so).

``run``, ``run_async``, ``rank_infos``, ``healthy`` and ``shutdown`` are
actor calls with the reference's meaning. What a member runs travels by
module and qualified name (``_private.code_ref``), never by value: a
function a gang runs must be defined at module level. A function's
exception raises ``WorkerError`` with the member's traceback.

The gang is the failure domain: one dead member wedges every member's
collectives, so a member's death raises the runtime's ``GangDiedError``
in the caller (the trainer restarts the whole gang from its checkpoint),
and ``shutdown`` kills every member and removes the group. The members
share the fate of the process that formed the gang: the runtime does not
end an actor's children with it, so each member watches that process and
exits when it is gone, rank 0 removing the group first (a Tune trial
killed while its trainer runs leaves no gang). Out of this port: gangs
across hosts (ROADMAP Queue A item 4).

With tracing on, each function a member runs is an ``execute <name>``
span under the caller's span (``tracing.inject()`` rides the call), so
what the function records, such as the profiler's step marks, joins the
caller's trace; the member flushes its spans before it answers.
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
import time
import traceback
from typing import Any, Callable, Sequence

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch._private.code_ref import pack
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

# How long the members may take to start and join their groups, once the
# gang's group is placed (a card's first use takes seconds).
START_TIMEOUT_S = 300.0
# The rendezvous port is probed free, then bound by rank 0's store: another
# process may take it between the two, and the members then start again on
# a new port, at most this many times in all.
START_ATTEMPTS = 3
# How long ``run`` waits, after a member's exception, for the others: an
# exception can be the echo of a peer's death (a collective whose other end
# is gone), which the runtime reports moments later.
ERROR_GRACE_S = 2.0
# How often a wait with no answer looks for a member whose process ended.
DEATH_CHECK_S = 0.5
# How often a member checks that the process that formed its gang lives.
CREATOR_POLL_S = 0.5

GangDiedError = exceptions.GangDiedError
# What a call to a dead member raises.
_DEATHS = (exceptions.ActorDiedError, exceptions.ActorUnavailableError,
           exceptions.WorkerCrashedError)


class WorkerError(RuntimeError):
    """A function a gang member ran raised; ``worker_traceback`` holds the
    member's traceback."""

    def __init__(self, rank: int, error: str, worker_traceback: str):
        super().__init__(f"gang member rank={rank} raised {error}\n{worker_traceback}")
        self.rank, self.worker_traceback = rank, worker_traceback


class GangContext:
    """Handed to every function a gang runs: rank identity and scratch
    state that persists across run() calls on the same member."""

    def __init__(self, rank: int, world_size: int, group_name: str, node_id: str, device):
        self.rank = rank
        self.world_size = world_size
        self.group_name = group_name
        self.node_id = node_id
        self.device = device
        self.state: dict[str, Any] = {}

    def collective(self):
        from ray_tpu_torch.util import collective

        return collective.get_group(self.group_name)


class _GangMember:
    """Actor hosting one rank of the gang. Its ``rank_info`` carries the
    wall times (``time.time()``) at which its constructor entered and at
    which it had joined both groups, and what its lease gave it."""

    def __init__(self, rank: int, world_size: int, group_name: str, backend: str,
                 collective_backend: str, master_port: int, use_gpu: bool,
                 env_vars: dict | None, collective_config=None, creator: tuple | None = None):
        # The member shares its creator's fate: ``creator`` is (the pid of
        # the process that formed the gang, the gang's placement group).
        if creator is not None:
            threading.Thread(target=_follow_creator, args=(rank, *creator), daemon=True,
                             name="gang-creator-watch").start()
        # A failure to join is kept and raised by every call, ``ping`` first
        # (the runtime retries an actor whose constructor raises until its
        # placement deadline, and the caller would see only that).
        self._start_error: str | None = None
        try:
            self._join(rank, world_size, group_name, backend, collective_backend,
                       master_port, use_gpu, env_vars, collective_config)
        except Exception:
            self._start_error = traceback.format_exc()

    def _join(self, rank, world_size, group_name, backend, collective_backend, master_port,
              use_gpu, env_vars, collective_config) -> None:
        entered = time.time()
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.util import collective

        for key, value in (env_vars or {}).items():
            os.environ[str(key)] = str(value)
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master_port),
                          RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
        device = torch.device("cpu")
        if use_gpu:
            if torch.cuda.device_count() < 1:
                raise RuntimeError(
                    f"gang member rank={rank} holds a GPU lease but opens no card "
                    f"(CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
            torch.cuda.set_device(0)
            device = torch.device("cuda", 0)
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=START_TIMEOUT_S))
        collective.init_collective_group(world_size, rank, backend=collective_backend,
                                         group_name=group_name, config=collective_config)
        self.gang_ctx = GangContext(rank, world_size, group_name,
                                    ray_tpu_torch.get_runtime_context()["node_id"], device)
        self._info = {
            "rank": rank, "node_id": self.gang_ctx.node_id, "pid": os.getpid(),
            "device": str(device), "entered": entered, "joined": time.time(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "current_device": torch.cuda.current_device() if use_gpu else None,
            # A ring member's listener, which answers comm_flight.
            "ring_address": getattr(self.gang_ctx.collective(), "address", None)}

    def _started(self) -> None:
        if self._start_error is not None:
            raise RuntimeError(f"gang member failed to start:\n{self._start_error}")

    def run(self, fn: Callable, args: tuple, kwargs: dict, trace: dict | None = None) -> Any:
        self._started()
        try:
            if tracing.enabled():
                # The reference's worker-side execute span, named for the
                # function: what it records (a profiler's step marks) joins it.
                with tracing.span(f"execute {getattr(fn, '__qualname__', fn)}", parent=trace,
                                  rank=self.gang_ctx.rank):
                    return fn(self.gang_ctx, *args, **kwargs)
            return fn(self.gang_ctx, *args, **kwargs)
        finally:
            tracing.flush()

    def rank_info(self) -> dict:
        self._started()
        return dict(self._info)

    def ping(self) -> str:
        self._started()
        return "ok"


def _follow_creator(rank: int, pid: int, pg) -> None:
    """Ends this member once the process that formed its gang is gone (a
    Tune trial's actor killed hard while its trainer ran): rank 0 first
    removes the gang's placement group, which no one else would."""
    while True:
        time.sleep(CREATOR_POLL_S)
        try:
            os.kill(pid, 0)
            continue
        except ProcessLookupError:
            pass
        except PermissionError:
            continue
        if rank == 0:
            try:
                remove_placement_group(pg)
            except Exception:  # the runtime is going too; the exit follows
                pass
        os._exit(1)


def _process_alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie, reaped late by the node
    agent, counts as ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


class WorkerGang:
    """``num_workers`` member actors, each on a card (``use_gpu``) or on the
    CPU, sharing one process group and collective group ``group_name``, in
    one placement group of ``resources_per_worker`` bundles ({"CPU": 1} by
    default; ``use_gpu`` adds a whole card). ``backend``: None (NCCL under
    ``use_gpu``, gloo otherwise), or "ring" (a gloo process group and a
    ``RingGroup`` with ``collective_config``; a member may then take a
    share of a card)."""

    def __init__(self, num_workers: int, *, use_gpu: bool = True,
                 resources_per_worker: dict | None = None, group_name: str | None = None,
                 ready_timeout: float = 300.0, backend: str | None = None,
                 collective_config=None, env_vars: dict | None = None):
        if backend not in (None, "ring"):
            raise ValueError(f"gang backend {backend!r}: None (the process group's own) "
                             "or 'ring'")
        self.num_workers = int(num_workers)
        self.group_name = group_name or f"gang-{os.urandom(4).hex()}"
        # The process group's backend; a ring's members meet over gloo.
        self.backend = "nccl" if use_gpu and backend is None else "gloo"
        self.collective_backend = backend or self.backend
        self.use_gpu = use_gpu
        self.members: list = []
        self._pids: list[int] = []
        bundle = {k: float(v) for k, v in (resources_per_worker or {"CPU": 1.0}).items()}
        if use_gpu:
            bundle.setdefault("GPU", 1.0)
            if bundle["GPU"] < 1 and backend != "ring" and self.num_workers > 1:
                raise ValueError(f"a GPU gang member takes a whole card (NCCL puts one rank "
                                 f"on a card), got {bundle['GPU']}; a ring gang, or a gang "
                                 f"of one, may share one")
        self._bundle = bundle
        for attempt in range(START_ATTEMPTS):
            self._place(ready_timeout)
            try:
                self._start_members(env_vars, collective_config)
                break
            except GangDiedError as exc:
                self.shutdown()
                if "EADDRINUSE" not in str(exc) or attempt + 1 == START_ATTEMPTS:
                    raise GangDiedError(f"gang failed to start: {exc}") from exc
            except BaseException:
                self.shutdown()
                raise

    def _place(self, ready_timeout: float) -> None:
        """Makes the gang's placement group (the reference's default
        strategy) and waits until it places."""
        self.pg = placement_group([dict(self._bundle) for _ in range(self.num_workers)],
                                  strategy="SPREAD")
        try:
            self.pg.ready(timeout=ready_timeout)
        except BaseException:
            # An attempt that cannot place leaves no PENDING group behind:
            # the controller would go on placing it (elastic step-down forms
            # gangs at several sizes in quick succession).
            remove_placement_group(self.pg)
            raise

    def _start_members(self, env_vars: dict | None, collective_config) -> None:
        """Starts one member a bundle on a fresh rendezvous port and waits
        until each has joined its groups."""
        bundle = dict(self._bundle)
        cpus, gpus = bundle.pop("CPU", 1.0), bundle.pop("GPU", 0.0)
        port = _free_port()
        member_cls = ray_tpu_torch.remote(_GangMember)
        self.spawned_at = time.time()
        self.members = [
            member_cls.options(
                num_cpus=cpus, num_gpus=gpus, resources=bundle or None,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=rank),
            ).remote(rank, self.num_workers, self.group_name, self.backend,
                     self.collective_backend, port, self.use_gpu, env_vars,
                     pack(collective_config), (os.getpid(), self.pg))
            for rank in range(self.num_workers)]
        try:
            self.get([m.ping.remote() for m in self.members], timeout=START_TIMEOUT_S)
            self._pids = [info["pid"] for info in self.rank_infos()]
        except (GangDiedError, WorkerError, TimeoutError) as exc:
            raise GangDiedError(f"gang members failed to start: {exc}") from exc

    # -- the reference's API -------------------------------------------------
    def run_async(self, fn: Callable, per_rank_args: Sequence[tuple] | None = None,
                  **kwargs) -> list:
        """Starts fn(gang_ctx, *args, **kwargs) on every member; returns one
        ref a rank, which ``get`` (or ``ray_tpu_torch.get``) resolves."""
        if per_rank_args is not None and len(per_rank_args) != self.num_workers:
            raise ValueError(f"per_rank_args has {len(per_rank_args)} entries for "
                             f"{self.num_workers} workers")
        # The caller's span parents each member's ``execute`` span.
        trace = tracing.inject()
        fn_packed, kwargs_packed = pack(fn), pack(kwargs)
        no_args = pack(())
        return [member.run.remote(fn_packed,
                                  pack(tuple(per_rank_args[rank])) if per_rank_args else no_args,
                                  kwargs_packed, trace)
                for rank, member in enumerate(self.members)]

    def run(self, fn: Callable, per_rank_args: Sequence[tuple] | None = None,
            timeout: float | None = None, **kwargs) -> list:
        """SPMD-executes fn(gang_ctx, *args, **kwargs) on every member and
        returns the results in rank order. A member's exception raises
        WorkerError; a member's death GangDiedError."""
        return self.get(self.run_async(fn, per_rank_args, **kwargs), timeout=timeout)

    def get(self, refs: list, timeout: float | None = None) -> list:
        """The values of ``run_async``'s refs in rank order. A member's death
        raises GangDiedError; a function's exception WorkerError, of the
        lowest rank that raised within ``ERROR_GRACE_S`` of the first (a
        death in that time raises GangDiedError instead); no answer within
        ``timeout`` TimeoutError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        values: dict[int, Any] = {}
        errors: dict[int, exceptions.TaskError] = {}
        pending = dict(enumerate(refs))
        grace = None  # set by the first exception
        while pending:
            now = time.monotonic()
            limits = [t for t in (deadline, grace) if t is not None]
            if limits and now >= min(limits):
                if errors:
                    break
                raise TimeoutError(f"gang members {sorted(pending)} answered nothing "
                                   f"within {timeout} s")
            wait_s = min([DEATH_CHECK_S] + [t - now for t in limits])
            ready, _ = ray_tpu_torch.wait(list(pending.values()), num_returns=1, timeout=wait_s)
            if not ready:
                # A call to a dead member waits for the runtime's record of
                # the death; its process's end shows at once.
                dead = self.died()
                if dead:
                    raise GangDiedError("gang member " + ", ".join(
                        f"rank={r}" for r in dead) + " died: its process ended")
                continue
            for rank in [r for r, ref in pending.items() if ref in ready]:
                try:
                    values[rank] = ray_tpu_torch.get(pending.pop(rank), timeout=0)
                except _DEATHS as exc:
                    raise GangDiedError(f"gang member rank={rank} died: {exc}") from exc
                except exceptions.TaskError as exc:
                    errors[rank] = exc
                    if grace is None:
                        grace = time.monotonic() + ERROR_GRACE_S
        if errors:
            dead = self.died()
            if dead:  # the errors echo a member's death: the gang died
                raise GangDiedError(f"gang members {dead} died; rank {min(errors)} then raised")
            rank = min(errors)
            tb = errors[rank].remote_traceback
            raise WorkerError(rank, tb.strip().splitlines()[-1] if tb.strip() else "", tb)
        return [values[rank] for rank in range(len(refs))]

    def died(self, within: float = 0.0) -> list[int]:
        """The ranks whose member's process has ended, waiting up to
        ``within`` seconds for one to: a member's error can be the echo of
        a peer's death, which the dead process's exit follows by moments.
        (The members share this host, so their processes are read directly;
        the runtime records a death later.)"""
        deadline = time.monotonic() + within
        while True:
            dead = [rank for rank, pid in enumerate(self._pids) if not _process_alive(pid)]
            if dead or time.monotonic() >= deadline:
                return dead
            time.sleep(0.02)

    def rank_infos(self) -> list[dict]:
        return ray_tpu_torch.get([m.rank_info.remote() for m in self.members], timeout=60)

    def healthy(self) -> bool:
        try:
            ray_tpu_torch.get([m.ping.remote() for m in self.members], timeout=30)
            return True
        except (exceptions.RayTpuError, TimeoutError):
            return False

    def shutdown(self) -> None:
        """Kills every member and removes the gang's placement group."""
        self._kill_members()
        try:
            remove_placement_group(self.pg)
        except exceptions.RayTpuError:
            pass  # the runtime is gone, and the group with it

    def _kill_members(self) -> None:
        for member in self.members:
            try:
                ray_tpu_torch.kill(member)
            except exceptions.RayTpuError:
                pass  # the member is already gone
