"""Collective groups: NCCL or gloo over ``torch.distributed``, and the
host-memory ``ring``.

Port of ray_tpu's ``util/collective/collective.py``. Its ``XlaGroup``
(device collectives across the ranks of one distributed runtime) becomes
``NcclGroup``, with the same ops, arguments and return shapes; its
``RingGroup`` (ring collectives through host memory, with the block-scaled
int8/fp8 wire) is ported as it is; and the module keeps
``init_collective_group`` / ``get_group`` / ``destroy_collective_group``
and the module-level ops. Each rank contributes one array (numpy or a
tensor) and gets the result in the same kind: numpy in, numpy out; a
tensor in, a tensor on its device out. A group of one rank returns its
input, as the reference's does.

  * ``allreduce(array, op)``: SUM, PRODUCT, MIN or MAX;
  * ``allgather(array)``: a list of world-size arrays, in rank order;
  * ``broadcast(array, src_rank)``;
  * ``reducescatter(array, op)``: ``np.array_split(reduced.reshape(-1),
    world)[rank]``;
  * ``barrier()``;
  * ``send`` / ``recv`` and ``p2p(array, src_rank, dst_rank)``.

``NcclGroup`` runs on the process group of the process (the gang's world,
or a one-rank group it starts itself). A PRODUCT of bf16 or f16 is taken
in f32 and rounded once (NCCL does not take a bf16 product on every
version); its reduce-scatter pads ``array_split``'s uneven chunks to the
largest; its ``recv`` needs ``like=`` and ``p2p`` is a paired op every
rank enters. It carries the group's ``CollectiveConfig``, and its wire
stays exact, as the reference's ``xla`` wire does.

``RingGroup`` (``backend="ring"``) is the reference's ring: a reduce-
scatter then an all-gather between neighbours, each hop a tagged message
to the next rank's mailbox. Each rank listens on a socket (a thread an
inbound connection), and its address goes into the process group's
``TCPStore`` (or ``store=``) under ``collective/{group}/rank/{r}``, where
the reference uses its controller's key-value store. ``send_async`` and
``recv`` pair messages by ``(peer, tag#seq)``, sequence numbers taken at
issue time; a timed-out recv does not advance its sequence. The exact
allreduce accumulates floats in f64 and sends the input dtype; with
``CollectiveConfig(quantize=...)`` a float SUM takes the quantized ring:
each reduce-scatter hop is encoded through the group's ``ErrorFeedback``
at site ``("rs", tag, step)``, the owner of each reduced chunk encodes it
once at ``("ag", tag)``, and the all-gather forwards that encoding
verbatim, so every rank decodes the same bytes. A tensor stays on its
device (the card's gradient is reduced and encoded there); only the wire
payload crosses to the host. The listener also answers a ``comm_flight``
query with this process's flight records (``comm_flight(address)``), the
evidence ``_private.hang_doctor`` merges. Left out until the runtime core
(ROADMAP Queue A item 14): rings across hosts (a rank listens on
127.0.0.1).

``HierarchicalGroup`` is the reference's ``hier`` backend:
``allreduce_sharded`` reduces the process's local shards on their device
(tier 1), then all-reduces the partial across the ranks (tier 2: the
process group's gloo or NCCL, or with ``backend="ring"`` the ring, as the
reference's).

Every op of a group (``allreduce``, ``allreduce_sharded``, ``allgather``,
``reducescatter``, ``broadcast``, ``barrier``, ``send``, ``recv``, as the
reference instruments them) goes through ``_instrumented``, once per
user-visible op (an op that calls another inside it records once): the
chaos latency points ``collective.<op>.rank<r>`` (before the flight
record) and ``collective.op.uniform`` (inside it), a flight record
(``flight.op_started``), with tracing on a ``collective.<op>`` span that
carries the record's ``comm_seq`` and ``comm_channel``, its ``bytes`` and
the ``wire_bytes`` the op put on the wire (the record takes the span's
trace id; the reference counts the group's bytes sent meanwhile, which is
the same unless ops run at once, as the bucketed overlap's do), and its wall time as the train step's "collective" phase
(``train.step_stats.record_phase``; one bool check outside a train
session), and each op feeds the ``rt_collective_bytes_total`` and
``rt_collective_op_latency_s`` series (``util.metrics.record_collective_op``,
tagged {op, backend}), which a runtime process flushes to the controller.
"""

from __future__ import annotations

import collections
import datetime
import functools
import inspect
import os
import pickle
import socket
import struct
import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from ray_tpu_torch._private import chaos
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.collective import flight
from ray_tpu_torch.util.collective.quantization import CollectiveConfig, ErrorFeedback
from ray_tpu_torch.util.collective.quantization import decode_device as _q_decode
from ray_tpu_torch.util.collective.quantization import to_host as _q_host

SUM, PRODUCT, MIN, MAX = "sum", "product", "min", "max"

_groups: dict[str, Any] = {}
_op_tls = threading.local()
# Wire bytes each thread has sent (RingGroup.send_async counts on the
# issuing thread): an op's span takes the difference over the op, so the
# bucketed overlap's concurrent ops do not count each other's bytes.
_sent_tls = threading.local()


def _thread_sent() -> int:
    return getattr(_sent_tls, "bytes", 0)


def _reduce_op(op: str):
    import torch.distributed as dist

    ops = {SUM: dist.ReduceOp.SUM, PRODUCT: dist.ReduceOp.PRODUCT, MIN: dist.ReduceOp.MIN,
           MAX: dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"collective op {op!r} is none of {sorted(ops)}")
    return ops[op]


class NcclGroup:
    """Elementwise collectives across the ranks of this process group (see
    the module docstring). ``backend`` is "nccl" (the card, the default) or
    "gloo" (the CPU); an initialized process group must have that backend,
    ``world_size`` ranks and this ``rank``. Without one, a group of one
    rank starts its own (rendezvous in a temporary directory); a larger
    one starts from ``MASTER_ADDR`` / ``MASTER_PORT``, as the gang sets
    them."""

    def __init__(self, world_size: int, rank: int, group_name: str, config: Any = None, *,
                 backend: str = "nccl"):
        import torch.distributed as dist

        if backend not in ("nccl", "gloo"):
            what = "is not an NcclGroup's" if backend in ("ring", "hier") else "is not ported"
            raise ValueError(f"collective backend {backend!r} {what}: NcclGroup runs 'nccl' "
                             "(the card) or 'gloo' (the CPU); 'ring' is RingGroup, 'hier' "
                             "HierarchicalGroup")
        if backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError("an NCCL collective group needs a CUDA device; pass "
                               "backend='gloo' for the CPU")
        self.world_size, self.rank, self.group_name = int(world_size), int(rank), group_name
        self.backend_name = backend
        # The group carries its config (the trainer's overlap default reads
        # it); the device wire stays exact, as the reference's xla wire.
        self.config = config or CollectiveConfig()
        self.wire_stats = {"bytes_sent": 0, "msgs_sent": 0}
        self._owns_process_group = False
        if not dist.is_initialized():
            if backend == "nccl":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) %
                                      torch.cuda.device_count())
            if self.world_size == 1:
                store = dist.FileStore(os.path.join(
                    tempfile.mkdtemp(prefix="ray_tpu_torch_collective_"), "store"), 1)
                dist.init_process_group(backend, store=store, rank=0, world_size=1)
            else:
                dist.init_process_group(backend, init_method="env://", rank=self.rank,
                                        world_size=self.world_size)
            self._owns_process_group = True
        if dist.get_backend() != backend:
            raise RuntimeError(f"collective group {group_name!r} asks for {backend}, the "
                               f"process group runs {dist.get_backend()}")
        if dist.get_world_size() != self.world_size or dist.get_rank() != self.rank:
            raise RuntimeError(
                f"collective group {group_name!r}: rank {self.rank} of {self.world_size}, but "
                f"the process group is rank {dist.get_rank()} of {dist.get_world_size()}")
        self.device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                       else torch.device("cpu"))

    # -- conversions: each op answers in the kind it was given ------------
    def _tensor(self, array) -> torch.Tensor:
        if isinstance(array, torch.Tensor):
            return array.detach().to(self.device).contiguous().clone()
        return torch.from_numpy(np.array(array)).to(self.device)

    @staticmethod
    def _back(t: torch.Tensor, like):
        if isinstance(like, torch.Tensor):
            return t
        return t.cpu().numpy()

    def _all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        import torch.distributed as dist

        if op == PRODUCT and t.dtype in (torch.bfloat16, torch.float16):
            wide = t.float()
            dist.all_reduce(wide, op=_reduce_op(op))
            return wide.to(t.dtype)
        dist.all_reduce(t, op=_reduce_op(op))
        return t

    # -- the reference's ops ------------------------------------------------
    def allreduce(self, array, op: str = SUM, tag: str = "__ar"):
        """``tag`` is the ring's; NCCL orders ops by issue and ignores it."""
        _reduce_op(op)
        if self.world_size == 1:
            return array if isinstance(array, torch.Tensor) else np.asarray(array)
        return self._back(self._all_reduce(self._tensor(array), op), array)

    def allgather(self, array) -> list:
        import torch.distributed as dist

        if self.world_size == 1:
            return [array if isinstance(array, torch.Tensor) else np.asarray(array)]
        t = self._tensor(array)
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t)
        return [self._back(p, array) for p in parts]

    def broadcast(self, array, src_rank: int = 0):
        import torch.distributed as dist

        if self.world_size == 1:
            return array if isinstance(array, torch.Tensor) else np.asarray(array)
        t = self._tensor(array)
        dist.broadcast(t, src=src_rank)
        return self._back(t, array)

    def reducescatter(self, array, op: str = SUM):
        """This rank's chunk of ``np.array_split`` of the reduced, flattened
        array."""
        import torch.distributed as dist

        _reduce_op(op)
        if self.world_size == 1:
            flat = array.reshape(-1) if isinstance(array, torch.Tensor) else \
                np.asarray(array).reshape(-1)
            return flat
        flat = self._tensor(array).reshape(-1)
        n, w = flat.numel(), self.world_size
        sizes = [n // w + (1 if i < n % w else 0) for i in range(w)]
        width = max(sizes)
        wide = flat.dtype in (torch.bfloat16, torch.float16) and op == PRODUCT
        chunks = [torch.nn.functional.pad(c.float() if wide else c, (0, width - c.numel()))
                  for c in torch.split(flat, sizes)]
        out = torch.empty(width, dtype=chunks[0].dtype, device=self.device)
        dist.reduce_scatter(out, chunks, op=_reduce_op(op))
        out = out[:sizes[self.rank]]
        return self._back(out.to(flat.dtype) if wide else out, array)

    def barrier(self) -> None:
        self.allreduce(torch.zeros(1, device=self.device))

    def p2p(self, array, src_rank: int, dst_rank: int):
        """Moves src's array to dst. Every rank of the group enters it with
        the same (src, dst), bystanders with a template of the same shape
        and dtype, as the reference's paired collective. Returns the array
        on dst, None elsewhere."""
        import torch.distributed as dist

        if src_rank == dst_rank:
            raise ValueError("p2p with src_rank == dst_rank is a local copy")
        t = self._tensor(array)
        if self.rank == src_rank:
            dist.send(t, dst=dst_rank)
        elif self.rank == dst_rank:
            dist.recv(t, src=src_rank)
            return self._back(t, array)
        return None

    def send(self, array, dst_rank: int, tag: str = "") -> None:
        """p2p send; ``dst_rank`` receives it with ``recv(src_rank=<this
        rank>, like=...)``."""
        if dst_rank == self.rank:
            raise ValueError("send to self is unsupported")
        self.p2p(array, self.rank, dst_rank)

    def recv(self, src_rank: int, tag: str = "", timeout: float = 60.0, like=None):
        """p2p receive; ``like`` gives the incoming shape and dtype (the
        reference's NCCL recv takes a buffer the same way)."""
        if like is None:
            raise ValueError("recv needs like=<array of the incoming shape/dtype>")
        if src_rank == self.rank:
            raise ValueError("recv from self is unsupported")
        zeros = (torch.zeros_like(like) if isinstance(like, torch.Tensor)
                 else np.zeros_like(like))
        return self.p2p(zeros, src_rank, self.rank)

    def destroy(self) -> None:
        """Ends the process group when this group started it."""
        import torch.distributed as dist

        if self._owns_process_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_process_group = False


# ---------------------------------------------------------------------------
# ring backend (host memory over the ranks' sockets)
# ---------------------------------------------------------------------------
# Frame kinds on a rank's listener: a tagged message, acknowledged with one
# byte once it is in the mailbox; a comm_flight query, answered with a frame.
_MSG, _FLIGHT = 1, 2
_HEAD = struct.Struct("!BI")  # kind, number of parts
_LEN = struct.Struct("!Q")
_RING_HOST = "127.0.0.1"
_RENDEZVOUS_S = 60.0  # how long a rank waits for the others' addresses
_REDUCERS = {SUM: torch.add, PRODUCT: torch.mul, MIN: torch.minimum, MAX: torch.maximum}
# Tensors numpy has no dtype for cross as their bits.
_BITS_OF = {torch.bfloat16: torch.int16}
if hasattr(torch, "float8_e4m3fn"):
    _BITS_OF[torch.float8_e4m3fn] = torch.uint8
_TENSOR_WIRE = "__tensor"


def _read_exact(sock: socket.socket, n: int) -> np.ndarray:
    # An uninitialized buffer: a zero-filled one costs a pass over a
    # gradient chunk's gigabytes before the first byte arrives.
    buf = np.empty(n, dtype=np.uint8)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError("the peer closed the connection")
        got += k
    return buf


def _frame(kind: int, obj) -> tuple[list, int]:
    """The pieces of a frame (pickle protocol 5, arrays out of band, so an
    array's bytes go to the socket without a copy) and its payload bytes."""
    buffers: list = []
    main = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    parts = [memoryview(main)] + [b.raw() for b in buffers]
    head = _HEAD.pack(kind, len(parts)) + b"".join(_LEN.pack(p.nbytes) for p in parts)
    return [head] + parts, sum(p.nbytes for p in parts)


def _write(sock: socket.socket, pieces: list) -> None:
    for piece in pieces:
        sock.sendall(piece)


def _read_frame(sock: socket.socket) -> tuple[int, Any]:
    kind, count = _HEAD.unpack(_read_exact(sock, _HEAD.size).tobytes())
    raw = _read_exact(sock, _LEN.size * count).tobytes()
    lengths = [_LEN.unpack_from(raw, i * _LEN.size)[0] for i in range(count)]
    parts = [_read_exact(sock, n) for n in lengths]
    return kind, pickle.loads(parts[0].tobytes(), buffers=parts[1:])


def _to_wire(x):
    """A payload as it crosses: a tensor as numpy on the host (its bits
    where numpy has no such dtype), lists and numbers as arrays."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        bits = _BITS_OF.get(t.dtype)
        if bits is not None:
            return (_TENSOR_WIRE, str(t.dtype).split(".")[-1], t.view(bits).cpu().numpy())
        return t.cpu().numpy()
    if isinstance(x, (list, int, float)):
        return np.asarray(x)
    return x


def _tensor_of(x, device) -> torch.Tensor:
    """A received payload (or an array given to an op) as a tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and len(x) == 3 and x[0] == _TENSOR_WIRE:
        return torch.from_numpy(x[2]).to(device).view(getattr(torch, x[1]))
    x = np.asarray(x)
    if not (x.flags.writeable and x.flags.c_contiguous) or x.ndim == 0:
        x = np.array(x)  # torch takes a writable, contiguous buffer
    return torch.from_numpy(x).to(device)


def comm_flight(address, last_n: int = 256, timeout: float = 10.0) -> dict:
    """Asks the ring listener at ``address`` (host, port) for its process's
    flight evidence: ``{"status", "rank", "pid", "records", "inflight",
    "stalls"}``. The listener answers on its own thread, so a rank blocked
    in a collective still answers."""
    with socket.create_connection(tuple(address), timeout=timeout) as sock:
        pieces, _ = _frame(_FLIGHT, {"last_n": int(last_n)})
        _write(sock, pieces)
        return _read_frame(sock)[1]


class _Link:
    """This rank's connection to one peer's listener. Frames go out in the
    caller's thread under the link's lock; a thread reads the peer's acks
    and completes the senders' futures in order."""

    def __init__(self, address):
        self.sock = socket.create_connection(tuple(address), timeout=60.0)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.lock = threading.Lock()
        self.pending: collections.deque = collections.deque()
        self.error: BaseException | None = None
        threading.Thread(target=self._acks, name="ring-acks", daemon=True).start()

    def send(self, pieces: list, fut: Future, launched) -> None:
        with self.lock:
            if self.error is not None:
                raise ConnectionError(f"ring link is down: {self.error!r}")
            self.pending.append(fut)
            launched()
            try:
                _write(self.sock, pieces)
            except OSError as exc:
                self._fail(exc)
                raise

    def _acks(self) -> None:
        try:
            while True:
                acks = self.sock.recv(4096)
                if not acks:
                    raise ConnectionError("the peer closed the connection")
                for _ in acks:
                    self.pending.popleft().set_result(None)
        except (OSError, IndexError) as exc:
            self._fail(exc)

    def _fail(self, exc: BaseException) -> None:
        self.error = self.error or exc
        while self.pending:
            fut = self.pending.popleft()
            if not fut.done():
                fut.set_exception(ConnectionError(f"ring link is down: {exc!r}"))

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already closed by the peer
        self.sock.close()


class RingGroup:
    """The reference's ring backend (see the module docstring): collectives
    through host memory between the ranks of ``group_name``, rendezvous in
    the process group's ``TCPStore`` (or ``store``). A numpy input is
    reduced on the CPU, a tensor on its own device."""

    backend_name = "ring"
    # A numpy input's reduction runs here.
    device = torch.device("cpu")

    def __init__(self, world_size: int, rank: int, group_name: str,
                 config: CollectiveConfig | None = None, *, store=None):
        self.world_size, self.rank, self.group_name = int(world_size), int(rank), group_name
        self.config = config or CollectiveConfig()
        # Payload bytes this rank put on the wire (frames, pickled).
        self.wire_stats: dict[str, int] = {"bytes_sent": 0, "msgs_sent": 0}
        self._ef = ErrorFeedback()
        self._mailbox: dict[tuple, Any] = {}
        self._arrived = threading.Condition()
        self._send_seq: dict[tuple, int] = {}
        self._recv_seq: dict[tuple, int] = {}
        self._barrier_epoch = 0
        self._links: dict[int, _Link] = {}
        self._links_lock = threading.Lock()
        self._closed = False
        self._server = socket.create_server((_RING_HOST, 0))
        self.address = self._server.getsockname()[:2]
        threading.Thread(target=self._serve, name=f"ring-{group_name}", daemon=True).start()
        self._store = store if store is not None else self._default_store()
        self._key = f"collective/{group_name}/rank/{rank}"
        self._store.set(self._key, f"{self.address[0]}:{self.address[1]}")
        self._peer_addrs = self._resolve_peers()

    # -- rendezvous in the process group's store ----------------------------
    @staticmethod
    def _default_store():
        import torch.distributed as dist
        from torch.distributed import distributed_c10d

        if not dist.is_initialized():
            raise RuntimeError("a ring group meets in the process group's TCPStore: "
                               "init_process_group first, or pass store=")
        return distributed_c10d._get_default_store()

    def _resolve_peers(self) -> dict[int, tuple]:
        keys = [f"collective/{self.group_name}/rank/{r}" for r in range(self.world_size)]
        try:
            self._store.wait(keys, datetime.timedelta(seconds=_RENDEZVOUS_S))
        except Exception as exc:
            raise TimeoutError(f"collective group {self.group_name}: not every one of "
                               f"{self.world_size} ranks registered within {_RENDEZVOUS_S} s"
                               ) from exc
        peers = {}
        for r, key in enumerate(keys):
            host, port = self._store.get(key).decode().rsplit(":", 1)
            peers[r] = (host, int(port))
        return peers

    # -- the listener: this rank's mailbox ----------------------------------
    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return  # destroyed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True,
                             name=f"ring-{self.group_name}-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                kind, obj = _read_frame(conn)
                if kind == _MSG:
                    src, tag, payload = obj
                    with self._arrived:
                        self._mailbox[(src, tag)] = payload
                        self._arrived.notify_all()
                    conn.sendall(b"\x01")
                elif kind == _FLIGHT:
                    reply = {"status": "ok", "rank": self.rank, "pid": os.getpid(),
                             "group": self.group_name,
                             "records": flight.snapshot(obj.get("last_n", 256)),
                             "inflight": flight.inflight_summary(),
                             "stalls": flight.stall_events()}
                    _write(conn, _frame(_FLIGHT, reply)[0])
        except (OSError, EOFError, pickle.UnpicklingError):
            pass  # the peer went away
        finally:
            conn.close()

    # -- p2p ------------------------------------------------------------------
    def _link(self, dst: int) -> _Link:
        with self._links_lock:
            link = self._links.get(dst)
            if link is None or link.error is not None:
                link = self._links[dst] = _Link(self._peer_addrs[dst])
            return link

    def send(self, array, dst_rank: int, tag: str = "") -> None:
        self.send_async(array, dst_rank, tag=tag).result()

    def send_async(self, payload, dst_rank: int, tag: str = "") -> Future:
        """Issues a p2p send and returns its Future, done when the peer has
        the message in its mailbox. Sequence numbers are taken at issue, so
        two sends to the same (dst, tag) stay ordered for the receiver.
        ``payload`` is any picklable object: an array, a tensor (it crosses
        as numpy) or a quantized wire tuple."""
        seq_key = (dst_rank, tag)
        seq = self._send_seq.get(seq_key, 0)
        self._send_seq[seq_key] = seq + 1
        pieces, nbytes = _frame(_MSG, (self.rank, f"{tag}#{seq}", _to_wire(payload)))
        self.wire_stats["bytes_sent"] += nbytes
        self.wire_stats["msgs_sent"] += 1
        _sent_tls.bytes = _thread_sent() + nbytes
        # Enqueued at issue, launched when the frame goes out, completed on
        # the peer's ack: the record names the mailbox slot (tag, seq).
        rec = flight.p2p_started(self.group_name, "send", tag, seq, self.rank, dst_rank,
                                 self.world_size, nbytes=nbytes)
        fut: Future = Future()
        if rec is not None:
            fut.add_done_callback(lambda f: flight.completed(rec, ok=f.exception() is None))
        try:
            self._link(dst_rank).send(pieces, fut, lambda: flight.launched(rec))
        except OSError as exc:
            if not fut.done():
                fut.set_exception(exc)
        return fut

    def _recv_payload(self, src_rank: int, tag: str, timeout: float):
        seq_key = (src_rank, tag)
        seq = self._recv_seq.get(seq_key, 0)
        key = (src_rank, f"{tag}#{seq}")
        # A recv blocked here is what the hang watchdog watches: the record
        # names (group, tag, seq) and the peer waited on.
        rec = flight.p2p_started(self.group_name, "recv", tag, seq, self.rank, src_rank,
                                 self.world_size)
        flight.launched(rec)
        with self._arrived:
            if not self._arrived.wait_for(lambda: key in self._mailbox, timeout):
                flight.completed(rec, ok=False)
                raise TimeoutError(f"collective group {self.group_name}: rank {self.rank} "
                                   f"got nothing from rank {src_rank} on {key[1]!r} within "
                                   f"{timeout} s")
            data = self._mailbox.pop(key)
        flight.completed(rec)
        # Only a recv that got its message advances the stream: a timed-out
        # one can be retried for the same sequence number.
        self._recv_seq[seq_key] = seq + 1
        return data

    def recv(self, src_rank: int, tag: str = "", timeout: float = 60.0, like=None):
        """The next message ``src_rank`` sent on ``tag``: as sent (numpy, or
        a wire tuple), or a tensor on ``like``'s device when ``like`` is a
        tensor (a sent bf16 tensor arrives as a CPU tensor)."""
        data = self._recv_payload(src_rank, tag, timeout)
        if isinstance(like, torch.Tensor):
            return _tensor_of(data, like.device)
        if isinstance(data, tuple) and len(data) == 3 and data[0] == _TENSOR_WIRE:
            return _tensor_of(data, "cpu")
        return data

    def p2p(self, array, src_rank: int, dst_rank: int):
        """Moves src's array to dst (only the two take part); returns it on
        dst, None elsewhere."""
        if self.rank == src_rank:
            self.send(array, dst_rank)
            return None
        if self.rank == dst_rank:
            return self.recv(src_rank, like=array if isinstance(array, torch.Tensor) else None)
        return None

    # -- the ops ----------------------------------------------------------------
    def _take(self, array) -> torch.Tensor:
        """An op's input as a tensor: a tensor where it lies, numpy on
        ``device``."""
        if isinstance(array, torch.Tensor):
            return array.detach()
        return torch.from_numpy(np.array(array)).to(self.device)

    @staticmethod
    def _give(t: torch.Tensor, like):
        return t if isinstance(like, torch.Tensor) else t.cpu().numpy()

    def barrier(self) -> None:
        """Dissemination barrier: log2(world) rounds of notifications."""
        epoch = self._barrier_epoch
        self._barrier_epoch += 1
        token = np.zeros(1)
        tag = f"__barrier{epoch}"
        round_num, step = 0, 1
        while step < self.world_size:
            dst = (self.rank + step) % self.world_size
            src = (self.rank - step) % self.world_size
            self.send(token, dst, tag=f"{tag}/r{round_num}")
            self.recv(src, tag=f"{tag}/r{round_num}")
            step *= 2
            round_num += 1

    def broadcast(self, array, src_rank: int = 0, tag: str = "__bc"):
        if self.world_size == 1 or self.rank == src_rank:
            for r in range(self.world_size):
                if r != src_rank:
                    self.send(array, r, tag=tag)
            return array if isinstance(array, torch.Tensor) else np.asarray(array)
        like = array if isinstance(array, torch.Tensor) else None
        return self.recv(src_rank, tag=tag, like=like)

    def allgather(self, array, tag: str = "__ag") -> list:
        """Ring all-gather: world_size - 1 neighbour hops."""
        if self.world_size == 1:
            return [array if isinstance(array, torch.Tensor) else np.asarray(array)]
        tensor = isinstance(array, torch.Tensor)
        chunks: list = [None] * self.world_size
        chunks[self.rank] = array if tensor else np.asarray(array)
        next_rank = (self.rank + 1) % self.world_size
        prev_rank = (self.rank - 1) % self.world_size
        current, pending = self.rank, None
        for _ in range(self.world_size - 1):
            if pending is not None:
                pending.result()
            pending = self.send_async(chunks[current], next_rank, tag=tag)
            current = (current - 1) % self.world_size
            chunks[current] = self.recv(prev_rank, tag=tag,
                                        like=array if tensor else None)
        pending.result()
        return chunks

    def _quantized(self, op: str, t: torch.Tensor) -> bool:
        """The quantized wire takes SUM over floats only (min/max/product
        and integer arrays take the exact wire)."""
        return (self.config.enabled and op == SUM and t.is_floating_point()
                and self.world_size > 1)

    def allreduce(self, array, op: str = SUM, tag: str = "__ar"):
        """Ring reduce-scatter, then all-gather (bandwidth-optimal). The
        wire carries the input dtype (or the quantized encoding), never an
        upcast; floats accumulate in f64 inside each hop's reduction."""
        if op not in _REDUCERS:
            raise ValueError(f"collective op {op!r} is none of {sorted(_REDUCERS)}")
        if self.world_size == 1:
            return array if isinstance(array, torch.Tensor) else np.asarray(array)
        t = self._take(array)
        if self._quantized(op, t):
            return self._give(self._allreduce_quantized(t, tag), array)
        wire_dtype = t.dtype
        acc_dtype = torch.float64 if t.is_floating_point() else t.dtype
        chunks = list(torch.tensor_split(t.reshape(-1), self.world_size))
        self._ring_reduce_scatter(chunks, _REDUCERS[op], f"{tag}/rs", start_idx=self.rank,
                                  acc_dtype=acc_dtype, wire_dtype=wire_dtype)
        next_rank = (self.rank + 1) % self.world_size
        prev_rank = (self.rank - 1) % self.world_size
        send_idx = (self.rank + 1) % self.world_size
        # The owned chunk goes back to the wire dtype before the all-gather,
        # so every rank ends with the same bits.
        chunks[send_idx] = chunks[send_idx].to(wire_dtype)
        pending = None
        for _ in range(self.world_size - 1):
            if pending is not None:
                pending.result()
            pending = self.send_async(chunks[send_idx], next_rank, tag=f"{tag}/ag")
            recv_idx = (send_idx - 1) % self.world_size
            chunks[recv_idx] = _tensor_of(self.recv(prev_rank, tag=f"{tag}/ag"), t.device)
            send_idx = recv_idx
        pending.result()
        return self._give(torch.cat(chunks).to(t.dtype).reshape(t.shape), array)

    def _ring_reduce_scatter(self, chunks: list, reducer, tag: str, start_idx: int,
                             acc_dtype=None, wire_dtype=None) -> int:
        """world_size - 1 ring rounds; afterwards this rank holds the fully
        reduced chunk at index (start_idx + 1) % world_size (returned).
        Outgoing partials are cast to ``wire_dtype``; the local reduction
        runs in ``acc_dtype``."""
        next_rank = (self.rank + 1) % self.world_size
        prev_rank = (self.rank - 1) % self.world_size
        send_idx, pending = start_idx, None
        for _ in range(self.world_size - 1):
            out = chunks[send_idx]
            if wire_dtype is not None and out.dtype != wire_dtype:
                out = out.to(wire_dtype)
            if pending is not None:
                pending.result()
            pending = self.send_async(out, next_rank, tag=tag)
            recv_idx = (send_idx - 1) % self.world_size
            local = chunks[recv_idx]
            incoming = _tensor_of(self.recv(prev_rank, tag=tag), local.device)
            if acc_dtype is not None:
                local, incoming = local.to(acc_dtype), incoming.to(acc_dtype)
            chunks[recv_idx] = reducer(local, incoming)
            send_idx = recv_idx
        if pending is not None:
            pending.result()
        return send_idx

    def _allreduce_quantized(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """Block-scaled quantized ring allreduce (SUM only). Reduce-scatter:
        each hop's outgoing chunk is encoded through the error-feedback
        residual of its (tag, step) site, and the receiver decodes and adds
        in f32. All-gather: the owner of each reduced chunk encodes it once
        (again through error feedback) and the others forward that encoding
        verbatim, so every rank decodes the same bytes. Encoding and
        decoding run on the tensor's device; ``q`` and the scales cross."""
        device = t.device
        next_rank = (self.rank + 1) % self.world_size
        prev_rank = (self.rank - 1) % self.world_size
        chunks = list(torch.tensor_split(t.reshape(-1).to(torch.float32), self.world_size))
        send_idx, pending = self.rank, None
        for step in range(self.world_size - 1):
            enc = _q_host(self._ef.encode_device(("rs", tag, step), chunks[send_idx],
                                                 self.config))
            if pending is not None:
                pending.result()
            pending = self.send_async(enc, next_rank, tag=f"{tag}/rs")
            recv_idx = (send_idx - 1) % self.world_size
            incoming = _q_decode(self.recv(prev_rank, tag=f"{tag}/rs"), device)
            chunks[recv_idx] = chunks[recv_idx] + incoming
            send_idx = recv_idx
        if pending is not None:
            pending.result()
            pending = None
        owned = (self.rank + 1) % self.world_size
        encoded = {owned: _q_host(self._ef.encode_device(("ag", tag), chunks[owned],
                                                         self.config))}
        send_idx = owned
        for _ in range(self.world_size - 1):
            if pending is not None:
                pending.result()
            pending = self.send_async(encoded[send_idx], next_rank, tag=f"{tag}/ag")
            recv_idx = (send_idx - 1) % self.world_size
            encoded[recv_idx] = self.recv(prev_rank, tag=f"{tag}/ag")
            send_idx = recv_idx
        pending.result()
        out = torch.cat([_q_decode(encoded[i], device) for i in range(self.world_size)])
        return out.to(t.dtype).reshape(t.shape)

    def reducescatter(self, array, op: str = SUM):
        """Each rank gets its 1/world_size slice of the reduction; runs only
        the reduce-scatter phase (half an allreduce's communication)."""
        if op not in _REDUCERS:
            raise ValueError(f"collective op {op!r} is none of {sorted(_REDUCERS)}")
        if self.world_size == 1:
            return array.reshape(-1) if isinstance(array, torch.Tensor) else \
                np.asarray(array).reshape(-1)
        t = self._take(array)
        acc_dtype = torch.float64 if t.is_floating_point() else t.dtype
        chunks = list(torch.tensor_split(t.reshape(-1), self.world_size))
        # Starting one chunk earlier lands the reduced chunk on index rank.
        owned = self._ring_reduce_scatter(chunks, _REDUCERS[op], "__rsc/rs",
                                          start_idx=(self.rank - 1) % self.world_size,
                                          acc_dtype=acc_dtype, wire_dtype=t.dtype)
        assert owned == self.rank
        return self._give(chunks[self.rank].to(t.dtype), array)

    def destroy(self) -> None:
        """Closes the listener and the links and takes this rank's address
        out of the store."""
        if self._closed:
            return
        self._closed = True
        self._server.close()
        with self._links_lock:
            for link in self._links.values():
                link.close()
            self._links.clear()
        try:
            self._store.delete_key(self._key)
        except Exception:  # the store went with its process group
            pass


class HierarchicalGroup:
    """Two-tier collectives (the reference's ``hier`` backend, "reduce within
    the slice, then across"): ``allreduce_sharded`` takes one shard per
    local device; tier 1 reduces them on the shards' device (the fast tier:
    the reference's one-jit psum over its local mesh), tier 2 all-reduces
    the one partial across the ranks (the slow tier: ``backend``, "nccl"
    or "gloo" over the process group, or "ring", a ``RingGroup`` carrying
    this group's config, as the reference's). Host-level ops (one array a
    rank) go to tier 2 alone, as the reference's delegate to its ring."""

    _TIER1 = {SUM: torch.sum, MAX: torch.amax, MIN: torch.amin}

    backend_name = "hier"

    def __init__(self, world_size: int, rank: int, group_name: str, config: Any = None, *,
                 backend: str = "nccl", store=None):
        self.world_size, self.rank, self.group_name = int(world_size), int(rank), group_name
        self.config = config or CollectiveConfig()
        if backend == "ring":
            self._dcn = RingGroup(world_size, rank, group_name + "@dcn", self.config,
                                  store=store)
        else:
            self._dcn = NcclGroup(world_size, rank, group_name + "@dcn", self.config,
                                  backend=backend)
        # The slow tier's wire accounting is this group's own.
        self.wire_stats = self._dcn.wire_stats
        self.device = self._dcn.device

    def _local_reduce(self, shards: list, op: str) -> torch.Tensor:
        if op not in self._TIER1:
            raise ValueError(f"hierarchical backend supports ops {sorted(self._TIER1)}")
        if not shards:
            raise ValueError("allreduce_sharded needs at least one shard")
        first = shards[0]
        device = first.device if isinstance(first, torch.Tensor) else self.device
        stacked = torch.stack([
            s.detach().to(device) if isinstance(s, torch.Tensor)
            else torch.from_numpy(np.array(s)).to(device) for s in shards])
        return self._TIER1[op](stacked, dim=0)

    def allreduce_sharded(self, per_device_arrays: list, op: str = SUM, tag: str = "__hier"):
        """The reduction of every rank's shards: tier 1 over this process's
        shards, tier 2 across the ranks. ``tag`` isolates concurrent
        reductions on a ring tier (the overlap path runs one a bucket) and
        keys its error-feedback residuals. Answers in the kind of the first
        shard (numpy in, numpy out; a tensor in, a tensor out)."""
        partial = self._local_reduce(list(per_device_arrays), op)
        out = self._dcn.allreduce(partial, op=op, tag=tag)
        return out if isinstance(per_device_arrays[0], torch.Tensor) else out.cpu().numpy()

    def allreduce(self, array, op: str = SUM, tag: str = "__ar"):
        return self._dcn.allreduce(array, op=op, tag=tag)

    def allgather(self, array) -> list:
        return self._dcn.allgather(array)

    def reducescatter(self, array, op: str = SUM):
        return self._dcn.reducescatter(array, op=op)

    def broadcast(self, array, src_rank: int = 0):
        return self._dcn.broadcast(array, src_rank=src_rank)

    def barrier(self) -> None:
        self._dcn.barrier()

    def send(self, array, dst_rank: int, tag: str = "") -> None:
        self._dcn.send(array, dst_rank, tag=tag)

    def recv(self, src_rank: int, tag: str = "", timeout: float = 60.0, like=None):
        return self._dcn.recv(src_rank, tag=tag, timeout=timeout, like=like)

    def destroy(self) -> None:
        self._dcn.destroy()


def init_collective_group(world_size: int, rank: int, backend: str = "nccl",
                          group_name: str = "default", config: Any = None, *,
                          store=None) -> None:
    """``backend``: "nccl", "gloo", "ring" (a RingGroup carrying ``config``,
    meeting in the process group's store or ``store``) or "hier" (a
    HierarchicalGroup whose tier 2 runs the initialized process group's
    backend, NCCL without one)."""
    import torch.distributed as dist

    if group_name in _groups:
        raise ValueError(f"collective group {group_name!r} already initialized")
    if backend == "ring":
        _groups[group_name] = RingGroup(world_size, rank, group_name, config, store=store)
    elif backend == "hier":
        wire = dist.get_backend() if dist.is_initialized() else "nccl"
        _groups[group_name] = HierarchicalGroup(world_size, rank, group_name, config,
                                                backend=wire)
    else:
        _groups[group_name] = NcclGroup(world_size, rank, group_name, config, backend=backend)


def get_group(group_name: str = "default"):
    if group_name not in _groups:
        raise ValueError(f"collective group {group_name!r} not initialized")
    return _groups[group_name]


def destroy_collective_group(group_name: str = "default") -> None:
    group = _groups.pop(group_name, None)
    if group is not None:
        group.destroy()


# Default tags the group methods use when the caller passes none: the
# flight record's channel must be what rides the wire.
_DEFAULT_TAGS = {
    "allreduce": "__ar",
    "allreduce_sharded": "__ar",
    "allgather": "__ag",
    "reducescatter": "__rs",
    "broadcast": "__bc",
    "barrier": "__barrier",
}


def _instrumented(op: str, group, array, call, tag=None):
    """Runs one collective op with its flight record and its wall time as
    the step's "collective" phase. A call inside another (a module wrapper
    calling the group's method, a hierarchical group's tier, broadcast's
    sends) records nothing: one record and one sample a user-visible op."""
    if getattr(_op_tls, "active", False):
        return call()
    _op_tls.active = True
    try:
        return _instrumented_outer(op, group, array, call, tag=tag)
    finally:
        _op_tls.active = False


def _nbytes(array) -> int:
    if isinstance(array, (list, tuple)):  # allreduce_sharded: a shard list
        return sum(_nbytes(a) for a in array)
    if isinstance(array, torch.Tensor):
        return array.numel() * array.element_size()
    return int(getattr(array, "nbytes", 0) or 0)


def _instrumented_outer(op: str, group, array, call, tag=None):
    from ray_tpu_torch.train import step_stats

    backend = getattr(group, "backend_name", "")
    nbytes = _nbytes(array) if array is not None else None
    wire = getattr(group, "wire_stats", None)
    wire_before = _thread_sent()
    # A windowed per-rank latency point plays a straggler that has not
    # reached the op yet: it sleeps before the flight record exists, so the
    # laggard's evidence is an absent record, which the hang report keys on.
    stall_delay = chaos.latency_delay(f"collective.{op}.rank{group.rank}")
    if stall_delay > 0:
        time.sleep(stall_delay)
    tag = tag if tag is not None else _DEFAULT_TAGS.get(op, "")
    rec = flight.op_started(group.group_name, op, tag, group.rank, group.world_size,
                            nbytes=nbytes or 0, backend=backend)
    start = time.perf_counter()
    if tracing.enabled():
        attrs = {"group": group.group_name, "world_size": group.world_size,
                 "rank": group.rank, "backend": backend, "op": op}
        if nbytes is not None:
            attrs["bytes"] = int(nbytes)
        if rec is not None:
            # The span carries the flight record's (seq, channel) and the
            # record the span's trace id: a hang report and a timeline
            # meet on either key.
            attrs["comm_seq"] = rec.seq
            attrs["comm_channel"] = rec.channel
        with tracing.span(f"collective.{op}", **attrs) as span:
            if span is not None and rec is not None:
                rec.trace_id = span.trace_id
            ok = False
            try:
                result = _chaos_uniform_then(call)
                ok = True
            finally:
                flight.completed(rec, ok=ok)
            if span is not None and wire is not None:
                span.attributes["wire_bytes"] = _thread_sent() - wire_before
    else:
        ok = False
        try:
            result = _chaos_uniform_then(call)
            ok = True
        finally:
            flight.completed(rec, ok=ok)
    elapsed = time.perf_counter() - start
    # Inside a train session this wall time is the step's "collective"
    # phase; outside one it is one bool check.
    step_stats.record_phase("collective", elapsed)
    from ray_tpu_torch.util import metrics

    wire_delta = _thread_sent() - wire_before if wire is not None else 0
    # Ring-family backends report the bytes they put on the wire; the
    # process group's own the logical payload.
    metrics.record_collective_op(op=op, backend=backend,
                                 nbytes=wire_delta if wire_delta else int(nbytes or 0),
                                 seconds=elapsed)
    return result


def _chaos_uniform_then(call):
    """The uniform-slowness point: unlike the per-rank one above, it sleeps
    inside the flight record on every rank that arms it, so completed ops'
    durations carry the slowness and the adaptive deadline absorbs it."""
    delay = chaos.latency_delay("collective.op.uniform")
    if delay > 0:
        time.sleep(delay)
    return call()


def _traced_method(op: str, fn):
    # Where the method's ``tag`` parameter sits positionally (past self),
    # resolved once: op names and tags are both str.
    params = list(inspect.signature(fn).parameters)
    tag_pos = params.index("tag") - 1 if "tag" in params else None

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        payload = args[0] if args else None
        tag = kwargs.get("tag")
        if tag is None and tag_pos is not None and len(args) > tag_pos:
            if isinstance(args[tag_pos], str):
                tag = args[tag_pos]
        return _instrumented(op, self, payload, lambda: fn(self, *args, **kwargs), tag=tag)
    return wrapper


# The group methods themselves are instrumented (trainers and gangs hold the
# group object and call it directly); the thread-local guard collapses the
# nesting to one record a user-visible op.
for _cls in (NcclGroup, RingGroup, HierarchicalGroup):
    for _op in ("allreduce", "allreduce_sharded", "allgather", "reducescatter",
                "broadcast", "barrier", "send", "recv"):
        _fn = _cls.__dict__.get(_op)
        if _fn is not None:
            setattr(_cls, _op, _traced_method(_op, _fn))


def allreduce(array, group_name: str = "default", op: str = SUM):
    return get_group(group_name).allreduce(array, op=op)


def allgather(array, group_name: str = "default") -> list:
    return get_group(group_name).allgather(array)


def reducescatter(array, group_name: str = "default", op: str = SUM):
    return get_group(group_name).reducescatter(array, op=op)


def broadcast(array, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(array, src_rank=src_rank)


def barrier(group_name: str = "default") -> None:
    get_group(group_name).barrier()


def send(array, dst_rank: int, group_name: str = "default") -> None:
    get_group(group_name).send(array, dst_rank)


def recv(src_rank: int, group_name: str = "default", timeout: float = 60.0, like=None):
    return get_group(group_name).recv(src_rank, timeout=timeout, like=like)
