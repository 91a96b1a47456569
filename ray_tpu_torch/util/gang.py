"""WorkerGang: an SPMD group of worker processes on one host, one a device.

Port of ray_tpu's ``util/gang.py`` (``GangContext``, ``_GangMember``,
``WorkerGang``) onto ``torch.multiprocessing`` (spawn). Each rank is a
process; ``MASTER_ADDR`` / ``MASTER_PORT`` come from a free port on this
host (the reference's ``coordinator="auto"``; a port another process takes
before rank 0 binds it starts the gang again on another), each member calls
``torch.distributed.init_process_group`` where the reference calls
``jax.distributed.initialize`` (NCCL on the card, gloo on the CPU), then
forms its collective group (``util.collective``). ``run``, ``run_async``,
``rank_infos``, ``healthy`` and ``shutdown`` keep their meaning.

``backend="ring"`` and ``collective_config`` are the reference's: the
members join a gloo process group, whose ``TCPStore`` holds the ring's
addresses, and form a ``RingGroup`` carrying the config; they never make
an NCCL communicator, so two members may share one card (a bundle of
``{"GPU": 0.5}`` each), which NCCL cannot do. The default backend stays
the process group's own: NCCL under ``use_gpu``, gloo on the CPU.

The gang is the failure domain: one dead member wedges every member's
collectives, so a member's death raises ``GangDiedError`` in the caller
(the trainer restarts the whole gang from its checkpoint), and
``shutdown`` reaps every process.

Formation takes the place of the reference's placement group: before it
spawns anything the gang leases one bundle a member (``resources_per_worker``,
a CPU by default, and a whole card under ``use_gpu``, or a share of one on a
ring) from the host's resource
ledger (``_private.resources``), waiting up to ``ready_timeout`` as the
reference's ``pg.ready`` does (the members' start then has
``START_TIMEOUT_S``), and raises the ledger's
``PlacementGroupUnschedulableError`` when they do not place (at once,
and as a ``ValueError`` too, when the host could never hold them, such as
more cards than it has). Each member runs on the card its bundle took,
not on card ``rank``: with card 1 leased elsewhere, a gang of three runs
on cards 0, 2 and 3. ``shutdown`` gives the lease back on every path, a
failed start included. Out of this port: gangs across hosts (ROADMAP
Queue A item 4).

With tracing on, each function a member runs is an ``execute <name>`` span
under the caller's span (``tracing.inject()`` rides the run message), so
what the function records, such as the profiler's step marks, joins the
caller's trace; the member flushes its spans before it answers.
"""

from __future__ import annotations

import os
import socket
import time
import traceback
from typing import Any, Callable, Sequence

import torch

from ray_tpu_torch._private import resources
from ray_tpu_torch.util import tracing

# How long the members may take to start and join their groups, once the
# gang's lease is placed (a card's first use takes seconds).
START_TIMEOUT_S = 300.0
# The rendezvous port is probed free, then bound by rank 0's store: another
# process may take it between the two, and the gang then starts again on a
# new port, at most this many times in all.
START_ATTEMPTS = 3


class GangDiedError(RuntimeError):
    """A gang member died, or the gang could not form."""


class WorkerError(RuntimeError):
    """A function a gang member ran raised; ``worker_traceback`` holds the
    member's traceback."""

    def __init__(self, rank: int, error: str, worker_traceback: str):
        super().__init__(f"gang member rank={rank} raised {error}\n{worker_traceback}")
        self.rank, self.worker_traceback = rank, worker_traceback


class _Channel:
    """A member's end of its pipe to the caller. ``stopped`` is set when a
    function the member runs reads the caller's ``stop`` (a train session
    waiting on its round): the member ends once that function returns."""

    def __init__(self, conn):
        self._conn = conn
        self.stopped = False

    def send(self, message) -> None:
        self._conn.send(message)

    def recv(self):
        message = self._conn.recv()
        if isinstance(message, tuple) and message[:1] == ("stop",):
            self.stopped = True
        return message


class GangContext:
    """Handed to every function a gang runs: rank identity, the channel to
    the caller, and scratch state that persists across run() calls on the
    same member."""

    def __init__(self, rank: int, world_size: int, group_name: str, node_id: str,
                 channel: _Channel, device: torch.device):
        self.rank = rank
        self.world_size = world_size
        self.group_name = group_name
        self.node_id = node_id
        self.channel = channel
        self.device = device
        self.state: dict[str, Any] = {}

    def collective(self):
        from ray_tpu_torch.util import collective

        return collective.get_group(self.group_name)


def _member_main(rank: int, world_size: int, group_name: str, backend: str,
                 master_port: int, card: int | None, conn, collective_backend: str | None = None,
                 collective_config=None) -> None:
    """A member process: join the process group and the collective group,
    then run what the caller sends until it says stop. Its ready message
    carries the wall times (``time.time()``) at which it entered, its
    imports done, and at which it had joined both groups."""
    entered = time.time()
    import torch.distributed as dist

    from ray_tpu_torch.util import collective

    channel = _Channel(conn)
    try:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master_port),
                          RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
        device = torch.device("cpu")
        if card is not None:
            torch.cuda.set_device(card)
            device = torch.device("cuda", card)
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size)
        collective.init_collective_group(world_size, rank,
                                         backend=collective_backend or backend,
                                         group_name=group_name, config=collective_config)
        ctx = GangContext(rank, world_size, group_name, socket.gethostname(), channel, device)
        channel.send(("ready", {"rank": rank, "node_id": ctx.node_id, "pid": os.getpid(),
                                "device": str(device), "entered": entered,
                                "joined": time.time(),
                                # A ring member's listener, which answers comm_flight.
                                "ring_address": getattr(ctx.collective(), "address", None)}))
    except Exception as exc:
        channel.send(("error", repr(exc), traceback.format_exc()))
        return
    try:
        while True:
            try:
                message = channel.recv()
            except EOFError:  # the caller closed the pipe
                break
            if message[0] == "stop":
                break
            _, fn, args, kwargs, trace = message
            try:
                if tracing.enabled():
                    # The reference's worker-side execute span: what the
                    # function records (a profiler's step marks) joins it.
                    with tracing.span(f"execute {getattr(fn, '__qualname__', fn)}",
                                      parent=trace, rank=rank):
                        result = fn(ctx, *args, **kwargs)
                else:
                    result = fn(ctx, *args, **kwargs)
            except Exception as exc:
                tracing.flush()
                channel.send(("error", repr(exc), traceback.format_exc()))
            else:
                tracing.flush()
                channel.send(("result", result))
            if channel.stopped:
                break
    finally:
        collective.destroy_collective_group(group_name)
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


class WorkerGang:
    """``num_workers`` member processes, each on a card (``use_gpu``) or on
    the CPU, sharing one process group and collective group ``group_name``.
    Each member leases ``resources_per_worker`` ({"CPU": 1} by default;
    ``use_gpu`` adds a whole card) from the host's ledger. ``backend``:
    None (NCCL under ``use_gpu``, gloo otherwise), or "ring" (a gloo
    process group and a ``RingGroup`` with ``collective_config``; a member
    may then lease a share of a card)."""

    def __init__(self, num_workers: int, *, use_gpu: bool = True,
                 resources_per_worker: dict | None = None, group_name: str | None = None,
                 ready_timeout: float = 300.0, backend: str | None = None,
                 collective_config=None):
        import torch.multiprocessing as mp

        if backend not in (None, "ring"):
            raise ValueError(f"gang backend {backend!r}: None (the process group's own) "
                             "or 'ring'")
        self.num_workers = int(num_workers)
        self.group_name = group_name or f"gang-{os.urandom(4).hex()}"
        # The process group's backend; a ring's members meet over gloo.
        self.backend = "nccl" if use_gpu and backend is None else "gloo"
        self.collective_backend = backend or self.backend
        self.collective_config = collective_config
        self.members, self._conns, self._infos = [], [], []
        bundle = dict(resources_per_worker or {"CPU": 1.0})
        if use_gpu:
            bundle.setdefault("GPU", 1.0)
            if bundle["GPU"] < 1 and backend != "ring":
                raise ValueError(f"a GPU gang member takes a whole card (NCCL puts one rank "
                                 f"on a card), got {bundle['GPU']}; a ring gang may share one")
        self._lease = resources.ledger().acquire(bundle, self.num_workers, timeout=ready_timeout)
        self.cards = [cards[0] if use_gpu else None for cards in self._lease.cards]
        try:
            for attempt in range(START_ATTEMPTS):
                try:
                    self._start_members(mp.get_context("spawn"))
                    break
                except GangDiedError as exc:
                    if "EADDRINUSE" not in str(exc) or attempt + 1 == START_ATTEMPTS:
                        raise
                    self._stop_members()
        except (GangDiedError, TimeoutError) as exc:
            self.shutdown()
            raise GangDiedError(f"gang failed to start: {exc}") from exc
        except BaseException:
            self.shutdown()
            raise

    def _start_members(self, ctx) -> None:
        """Spawns the members on a fresh rendezvous port and waits for each
        one's ready message."""
        self.members, self._conns, self._infos = [], [], []
        port = _free_port()
        self.spawned_at = time.time()
        for rank in range(self.num_workers):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_member_main, name=f"{self.group_name}-rank{rank}",
                               args=(rank, self.num_workers, self.group_name, self.backend,
                                     port, self.cards[rank], child, self.collective_backend,
                                     self.collective_config))
            proc.start()
            child.close()
            self.members.append(proc)
            self._conns.append(parent)
        deadline = time.monotonic() + START_TIMEOUT_S
        for rank in range(self.num_workers):
            kind, *body = self.recv(rank, timeout=max(0.0, deadline - time.monotonic()))
            if kind != "ready":
                raise GangDiedError(f"gang member rank={rank} failed to start: "
                                    f"{body[0]}\n{body[1]}")
            self._infos.append(body[0])

    # -- messages ------------------------------------------------------------
    def send(self, rank: int, message) -> None:
        """Sends ``message`` to member ``rank``; GangDiedError when the
        member is gone."""
        try:
            self._conns[rank].send(message)
        except OSError as exc:  # a broken pipe: the member died
            raise GangDiedError(f"gang member rank={rank} is gone: {exc!r}") from exc

    def recv(self, rank: int, timeout: float | None = None):
        """The next message from member ``rank``. Raises GangDiedError when
        any member has died (the gang is the failure domain), TimeoutError
        after ``timeout`` seconds."""
        return self.recv_any([rank], timeout)[1]

    def recv_any(self, ranks, timeout: float | None = None) -> tuple[int, Any]:
        """(rank, message) of the first of ``ranks`` with a message, lowest
        rank first. Raises as ``recv``."""
        from multiprocessing.connection import wait

        conns = [self._conns[r] for r in ranks]
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            for rank, conn in zip(ranks, conns):
                if conn.poll():
                    try:
                        return rank, conn.recv()
                    except (EOFError, OSError):
                        pass  # the member is gone; its exit code says how
            dead = [(r, p.exitcode) for r, p in enumerate(self.members)
                    if p.exitcode is not None]
            if dead:
                raise GangDiedError(
                    "gang member died: " + ", ".join(f"rank={r} exit code {c}" for r, c in dead))
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(f"gang members {list(ranks)} sent nothing within {timeout} s")
            wait(conns + [p.sentinel for p in self.members],
                 timeout=None if left is None else min(left, 5.0))

    # -- the reference's API -------------------------------------------------
    def run_async(self, fn: Callable, per_rank_args: Sequence[tuple] | None = None,
                  **kwargs) -> None:
        """Sends fn(gang_ctx, *args, **kwargs) to every member; its results
        (and any messages it sends first, such as a session's reports)
        arrive through ``recv``."""
        if per_rank_args is not None and len(per_rank_args) != self.num_workers:
            raise ValueError(f"per_rank_args has {len(per_rank_args)} entries for "
                             f"{self.num_workers} workers")
        # The caller's span parents each member's ``execute`` span.
        trace = tracing.inject()
        for rank in range(self.num_workers):
            args = tuple(per_rank_args[rank]) if per_rank_args else ()
            self.send(rank, ("run", fn, args, kwargs, trace))

    def run(self, fn: Callable, per_rank_args: Sequence[tuple] | None = None,
            timeout: float | None = None, **kwargs) -> list:
        """SPMD-executes fn(gang_ctx, *args, **kwargs) on every member and
        returns the results in rank order. A member's exception raises
        WorkerError; a member's death GangDiedError."""
        self.run_async(fn, per_rank_args, **kwargs)
        results = []
        for rank in range(self.num_workers):
            kind, *body = self.recv(rank, timeout=timeout)
            if kind == "error":
                raise WorkerError(rank, body[0], body[1])
            if kind != "result":
                raise RuntimeError(f"gang member rank={rank} sent {kind!r} during run()")
            results.append(body[0])
        return results

    def died(self, within: float = 0.0) -> list[int]:
        """The ranks whose process has exited, waiting up to ``within``
        seconds for one to: a member's error can be the echo of a peer's
        death (a collective whose other end is gone), which the dead
        process's exit follows by moments."""
        from multiprocessing.connection import wait

        wait([p.sentinel for p in self.members], timeout=within)
        return [r for r, p in enumerate(self.members) if p.exitcode is not None]

    def rank_infos(self) -> list[dict]:
        return list(self._infos)

    def healthy(self) -> bool:
        return all(p.is_alive() for p in self.members)

    def shutdown(self, grace_s: float = 5.0) -> None:
        """Asks every live member to stop, then kills what is left, reaps
        every process and gives the gang's lease back."""
        try:
            self._stop_members(grace_s)
        finally:
            self._lease.release()

    def _stop_members(self, grace_s: float = 5.0) -> None:
        for rank, proc in enumerate(self.members):
            if proc.is_alive():
                try:
                    self.send(rank, ("stop",))
                except GangDiedError:
                    pass  # the member is already gone
        deadline = time.monotonic() + grace_s
        for proc in self.members:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in self.members:
            if proc.is_alive():
                proc.kill()
            proc.join()
        for conn in self._conns:
            conn.close()
