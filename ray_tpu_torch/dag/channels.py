"""The channel families: the typed edges of a compiled dataflow graph.

The counterpart of ray_tpu's ``dag/channels.py``. A compiled edge is one
of four families, chosen by the compile-time placement plan
(``dag/placement.py``):

* ``ShmChannel``    host payloads of co-located ends ride a seq-framed
                    bounded ring of slots (``dag/channel.py``). The steady
                    state is pure write and poll: no message of any kind
                    moves per hop.
* ``DeviceChannel`` the graph's own process group (``DeviceGroup``): host
                    values (numpy, CPU tensors) go over gloo send/recv, as
                    the reference's ring wire carries them; a CUDA tensor
                    whose two ends see the same card goes as a CUDA IPC
                    handle (pickled as ``torch.multiprocessing`` reduces
                    it), with an interprocess event the consumer waits on;
                    a CUDA tensor between two cards goes over NCCL
                    send/recv. A CUDA payload that can take none of these
                    raises: it never moves through the host instead.
* ``LocalChannel``  a bounded in-process asyncio ring for same-process
                    streams.
* socket            the per-push message fallback (no channel object: the
                    driver and the actors send ``dag_push``/``dag_pop`` to
                    an actor's graph socket), for edges that ask for it.

Device tags follow the reference's skeleton,
``dagch:p{epoch}:e{src}:{dst}:{slot}``; gloo matches integer tags, so each
string maps to its CRC-32 (``int_tag``), and a graph refuses at compile two
edges of one pair of ranks whose tags collide. A group is built once per
graph and epoch on a ``TCPStore`` the driver hosts (rank 0), and is never
the process's default group, so a graph may be compiled inside a gang
member or beside other groups. The epoch rides the tag and the group, so
a frame sent before a recovery lands in a group no post-recovery pop
reads.

With a ``wire_cfg`` (the graph's ``quantize_wire``), a ``DeviceChannel``
block-scale quantizes the float numpy arrays it carries (host payloads)
with an error-feedback residual an edge, in the reference's envelope
``("__act", shape, dtype, wire tuple)``; every other payload stays exact.
Every push and pop records into the comm flight ring under
``flight.site("dag")``: a note a shm push or pop, a note a device push, and
a recv record around a blocking device pop, which the watchdog watches.

With tracing on and a context flowing (the caller's, else the ambient
span's), a push opens a ``channel.push`` span whose own context rides the
frame: in a shm slot's header (``tracing.pack_ctx``), on a device or local
edge in the reference's envelope ``("__tr", ctx, payload)``. The consumer
emits a ``channel.pop`` span parented on it, covering its wait, and keeps
the context on ``last_trace`` (the executor parents its stage span on
it). The flight records a hop makes carry its trace id. A device pop
sleeps first for the chaos latency point ``dag.device.pop``. The
untraced path costs one attribute read and one ``b"\x00"`` byte a shm
frame.
"""

from __future__ import annotations

import asyncio
import collections
import datetime
import io
import json
import os
import pickle
import queue
import struct
import sys
import threading
import time
import zlib

from ray_tpu_torch._private import chaos
from ray_tpu_torch.dag import channel as shm
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.collective import flight

# Marker of a codec-compressed payload, the envelope the pipeline's
# activation wire uses too.
_ACT_WIRE = "__act"

# Marker of a payload carrying a trace context, ``(marker, ctx, payload)``:
# device and local edges have no frame header to extend. Written only
# while a context flows, so an untraced payload is unchanged.
_TR_WIRE = "__tr"


def _resolve_ctx(trace):
    """The context a push propagates: the caller's (a popped upstream
    context), else the ambient span's (None while tracing is off)."""
    return trace if trace is not None else tracing.inject()


def _push_span(ctx, *, channel: str, family: str, seq, nbytes: int):
    """Opens the ``channel.push`` span whose own context rides the wire, so
    that the consumer's ``channel.pop`` parents on it."""
    if ctx is None:
        return None, None
    span = tracing.begin("channel.push", parent=ctx, channel=channel, family=family,
                         seq=seq, nbytes=nbytes)
    return span, {"trace_id": span.trace_id, "span_id": span.span_id}


def _emit_pop(ctx, started: float, **attributes) -> None:
    """The consumer's ``channel.pop`` span, covering its wait."""
    wait_s = time.monotonic() - started
    end_ns = time.time_ns()
    tracing.emit("channel.pop", ctx, start_ns=end_ns - int(wait_s * 1e9), end_ns=end_ns,
                 **attributes)


class ChannelClosedError(RuntimeError):
    """The channel's owning loop was stopped while an op was blocked."""


class ShmChannel:
    """One shm-ring edge: a bounded ring of seq-framed slots. The producer
    waits on slot reuse (the consumer's free IS the backpressure release);
    the consumer polls without blocking, backing off while idle."""

    def __init__(self, store, base: str, depth: int, *, epoch: int = 0, group: str = "dag"):
        self._store = store
        self.base = base
        self.depth = depth
        self.epoch = epoch
        self._group = group
        # The trace context of the last pop (one consumer a ring).
        self.last_trace: dict | None = None

    def push(self, seq: int, value, timeout: float = 120.0, stop=None,
             trace: dict | None = None) -> None:
        parts, total = shm.serialize_parts(value)
        self.push_parts(seq, parts, total, timeout=timeout, stop=stop, trace=trace)

    def push_parts(self, seq: int, parts, total: int, timeout: float = 120.0,
                   stop=None, trace: dict | None = None) -> None:
        ctx = _resolve_ctx(trace)
        span, wire_ctx = _push_span(ctx, channel=self.base, family="shm", seq=seq, nbytes=total)
        wire = tracing.pack_ctx(wire_ctx) if wire_ctx else b""
        name = shm.slot_name(self.base, seq, self.depth)
        deadline = time.monotonic() + timeout
        while not shm.try_write_seq(self._store, name, seq, parts, total, epoch=self.epoch,
                                    trace=wire):
            if stop is not None and stop():
                raise ChannelClosedError(f"{self.base}: channel closed")
            if time.monotonic() > deadline:
                raise TimeoutError(f"channel slot {name} still unread after {timeout}s")
            time.sleep(0.0005)
        with flight.site("dag"), flight.trace(ctx["trace_id"] if ctx else None):
            flight.note(self._group, "chan_push", tag=self.base, nbytes=total)
        if span is not None:
            tracing.finish(span)

    def pop(self, seq: int, timeout: float | None = None, stop=None):
        name = shm.slot_name(self.base, seq, self.depth)
        deadline = None if timeout is None else time.monotonic() + timeout
        started = time.monotonic()
        delay = 0.0002
        trace_out: list = []
        while True:
            value = shm.read_seq_consume(self._store, name, seq, epoch=self.epoch,
                                         trace_out=trace_out)
            if value is not shm.NOT_READY:
                ctx = tracing.unpack_ctx(trace_out[0]) if trace_out else None
                self.last_trace = ctx
                with flight.site("dag"), flight.trace(ctx["trace_id"] if ctx else None):
                    flight.note(self._group, "chan_pop", tag=self.base)
                if ctx is not None:
                    _emit_pop(ctx, started, channel=self.base, family="shm", seq=seq)
                return value
            if stop is not None and stop():
                raise ChannelClosedError(f"{self.base}: channel closed")
            now = time.monotonic()
            if deadline is not None and now > deadline:
                raise TimeoutError(f"channel slot {name} not ready in {timeout}s")
            time.sleep(delay)
            # A hot edge stays near the floor; a cold one backs off to 50 ms.
            delay = min(delay * 2, 0.002 if now - started < 1.0 else 0.05)

    def free_slots(self) -> None:
        """Deletes every ring slot (teardown; idempotent)."""
        for i in range(self.depth):
            shm._free_slot(self._store, f"{self.base}-{i}")


# ------------------------------------------------------------- device wire
# Frame kinds on the gloo wire: a header int64[4] (kind, body bytes, 0, 0),
# then the body. VALUE: a pickled value (CUDA tensors inside it as IPC or
# NCCL references); ACK: the consumer is done with a VALUE's IPC tensors;
# CLOSE: the sender leaves this (peer, tag) for good.
VALUE, ACK, CLOSE = 1, 2, 3
_GROUP_TIMEOUT = datetime.timedelta(days=1)
_CLOSE_WAIT_S = 5.0
# Opened IPC storages a channel keeps, so the next tensor from the same
# allocation opens no handle again.
_IPC_CACHE = 4


def int_tag(tag: str) -> int:
    """The gloo tag of a string tag (CRC-32, 31 bits)."""
    return zlib.crc32(tag.encode()) & 0x7FFFFFFF


def _is_cuda_tensor(obj) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(obj, torch.Tensor) and obj.is_cuda


def visible_cards() -> list[str]:
    """This process's cards by identity (UUID), index = local device index."""
    import torch

    if not torch.cuda.is_available():
        return []
    cards = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        uuid = getattr(props, "uuid", None)
        cards.append(str(uuid) if uuid is not None else
                     f"{props.name}:{props.pci_domain_id}:{props.pci_bus_id}:"
                     f"{props.pci_device_id}")
    return cards


def host_store(timeout_s: float = 120.0):
    """A ``TCPStore`` this process hosts on a free local port (rank 0)."""
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def join_store(port: int, timeout_s: float = 120.0):
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", port, is_master=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


class DeviceGroup:
    """A graph's process group for one epoch, standalone on ``store``: gloo
    for host values and frames, NCCL (built only where two ranks hold
    different cards) for CUDA tensors between cards, CUDA IPC for CUDA
    tensors on one card. Its constructor is the rendezvous: every rank
    builds it at once."""

    def __init__(self, store, name: str, rank: int, world_size: int):
        import torch
        import torch.distributed as dist

        self.name, self.rank, self.world_size = name, rank, world_size
        self.store = store
        gloo = dist.ProcessGroupGloo
        opts = gloo._Options()
        opts._devices = [gloo.create_device(hostname="127.0.0.1")]
        opts._timeout = _GROUP_TIMEOUT
        self.gloo = gloo(dist.PrefixStore(f"{name}/gloo", store), rank, world_size, opts)
        self.cards = visible_cards()
        store.set(f"{name}/cards/{rank}", json.dumps(self.cards))
        keys = [f"{name}/cards/{r}" for r in range(world_size)]
        store.wait(keys)
        self.peer_cards = [json.loads(store.get(k)) for k in keys]
        self.nccl = None
        if all(self.peer_cards) and any(
                not set(a) & set(b) for a in self.peer_cards for b in self.peer_cards):
            self.nccl = dist.ProcessGroupNCCL(
                dist.PrefixStore(f"{name}/nccl", store), rank, world_size)
        self._send_locks: dict = collections.defaultdict(threading.Lock)
        self._copy_streams: dict = {}
        self.torch = torch

    # -- frames ----------------------------------------------------------
    def send_frame(self, peer: int, tag: int, kind: int, body=()) -> None:
        """A header, then ``body`` (a uint8 tensor) when it is not empty."""
        torch = self.torch
        head = torch.tensor([kind, len(body), 0, 0], dtype=torch.int64)
        with self._send_locks[(peer, tag)]:
            self.gloo.send([head], peer, tag).wait()
            if len(body):
                self.gloo.send([body], peer, tag).wait()

    def recv_frame(self, peer: int, tag: int):
        """(kind, body uint8 tensor) of the next frame from ``peer`` on
        ``tag``, blocking (no timeout: a gloo wait that times out closes the
        pair)."""
        torch = self.torch
        head = torch.empty(4, dtype=torch.int64)
        self.gloo.recv([head], peer, tag).wait()
        kind, n = int(head[0]), int(head[1])
        body = torch.empty(n, dtype=torch.uint8)
        if n:
            self.gloo.recv([body], peer, tag).wait()
        return kind, body

    def mailbox(self, peer: int, tag: int, once: bool = False) -> "Mailbox":
        return Mailbox(self, peer, tag, once)

    def close_links(self, links) -> None:
        """Sends CLOSE on each (peer, tag) this rank sends on, so the peer's
        mailbox thread ends; in the background, bounded (a dead peer fails
        the send; one that never opened its end gives up after a while)."""
        def close(peer, tag):
            try:
                self.send_frame(peer, tag, CLOSE)
            except Exception:  # rtlint: disable=swallowed-exception - the peer is gone; its mailbox ended with it
                pass

        threads = [threading.Thread(target=close, args=link, daemon=True,
                                    name="dag-close") for link in links]
        for t in threads:
            t.start()
        deadline = time.monotonic() + _CLOSE_WAIT_S
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def copy_stream(self, device: int):
        stream = self._copy_streams.get(device)
        if stream is None:
            stream = self._copy_streams[device] = self.torch.cuda.Stream(device=device)
        return stream


class Mailbox:
    """A thread that keeps a gloo recv posted on one (peer, tag) and queues
    what arrives: a gloo send waits until its receiver has posted, so a
    producer never waits on a consumer that is still busy, and a pop can
    wait in slices (a gloo wait that times out closes the pair)."""

    def __init__(self, group: DeviceGroup, peer: int, tag: int, once: bool = False):
        self.group, self.peer, self.tag, self.once = group, peer, tag, once
        self.q: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"dag-mailbox-{peer}-{tag}")
        self.thread.start()

    def _run(self) -> None:
        while True:
            try:
                kind, body = self.group.recv_frame(self.peer, self.tag)
            except Exception as exc:  # the peer's pair closed: it died or left
                self.q.put((CLOSE, exc))
                return
            self.q.put((kind, body))
            if kind == CLOSE or self.once:
                return

    def get(self, timeout: float | None = None, stop=None):
        """(kind, body uint8 tensor); waits in slices while ``stop`` allows."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if stop is not None and stop():
                raise ChannelClosedError("stage loop stopped")
            left = 0.1 if deadline is None else min(0.1, deadline - time.monotonic())
            if left <= 0:
                raise TimeoutError(f"no frame from rank {self.peer} on tag {self.tag}")
            try:
                kind, body = self.q.get(timeout=left)
            except queue.Empty:
                continue
            if kind == CLOSE:
                self.q.put((kind, body))  # every later get sees it too
                cause = f": {type(body).__name__}: {body}" if isinstance(body, Exception) else ""
                raise ChannelClosedError(f"rank {self.peer} closed tag {self.tag}{cause}")
            return kind, body


def _card_of(group: DeviceGroup, tensor) -> str:
    return group.cards[tensor.device.index]


class _Encoder(pickle.Pickler):
    """Pickles a value for one peer; each CUDA tensor becomes a reference:
    ("ipc", ...) when the peer sees its card, ("nccl", i) otherwise."""

    def __init__(self, file, group: DeviceGroup, peer: int, buffers: list):
        super().__init__(file, protocol=5, buffer_callback=buffers.append)
        self.group, self.peer = group, peer
        self.held: list = []   # tensors and events the consumer reads until its ACK
        self.nccl: list = []   # tensors that follow the frame over NCCL

    def persistent_id(self, obj):
        if not _is_cuda_tensor(obj):
            return None
        import torch
        from torch.multiprocessing.reductions import reduce_tensor

        group = self.group
        card = _card_of(group, obj)
        if card in group.peer_cards[self.peer]:
            _, args = reduce_tensor(obj)
            event = torch.cuda.Event(interprocess=True)
            event.record(torch.cuda.current_stream(obj.device))
            self.held += [obj, event]
            args = list(args)
            args[6] = None  # the consumer's index of the same card goes here
            return ("ipc", card, tuple(args), event.ipc_handle())
        if group.nccl is None:
            raise RuntimeError(
                f"a CUDA tensor on card {card} cannot reach rank {self.peer} "
                f"(cards {group.peer_cards[self.peer] or 'none'}): no CUDA IPC to "
                "another card and no NCCL group; it is not moved through the host")
        self.nccl.append(obj.contiguous())
        return ("nccl", len(self.nccl) - 1, tuple(obj.shape), str(obj.dtype))


class _Decoder(pickle.Unpickler):
    """The inverse of ``_Encoder``: IPC tensors are copied to memory of
    this process on a side stream that waits on the producer's event (so
    the producer can reuse its block after the ACK); NCCL tensors are
    received in order."""

    def __init__(self, file, group: DeviceGroup, peer: int, buffers, cache):
        super().__init__(file, buffers=buffers)
        self.group, self.peer, self.cache = group, peer, cache
        self.copies: list = []
        self.ipc = False

    def persistent_load(self, pid):
        import torch
        from torch.multiprocessing.reductions import rebuild_cuda_tensor

        group = self.group
        if pid[0] == "nccl":
            _, _, shape, dtype = pid
            buf = torch.empty(shape, dtype=getattr(torch, dtype.split(".")[-1]),
                              device=torch.cuda.current_device())
            group.nccl.recv([buf], self.peer, 0).wait()
            return buf
        _, card, args, event_handle = pid
        if card not in group.cards:
            raise RuntimeError(f"an IPC tensor of card {card}, which this process "
                               f"does not see (cards {group.cards})")
        device = group.cards.index(card)
        args = list(args)
        args[6] = device
        side = group.copy_stream(device)
        with torch.cuda.device(device), torch.cuda.stream(side):
            shared = rebuild_cuda_tensor(*args)
            side.wait_event(torch.cuda.Event.from_ipc_handle(device, event_handle))
            out = shared.clone()
            done = torch.cuda.Event()
            done.record(side)
        current = torch.cuda.current_stream(device)
        current.wait_stream(side)
        out.record_stream(current)
        # Keep the opened allocation mapped for the next tensor from it.
        key = args[7]
        self.cache.pop(key, None)
        self.cache[key] = shared.untyped_storage()
        while len(self.cache) > _IPC_CACHE:
            self.cache.pop(next(iter(self.cache)))
        self.copies.append(done)
        self.ipc = True
        return out


def encode(group: DeviceGroup, peer: int, value):
    """(body uint8 tensor, held, nccl tensors) of one VALUE frame: the
    buffer count and lengths, the pickle, then its out-of-band buffers."""
    import torch

    buffers: list = []
    out = io.BytesIO()
    enc = _Encoder(out, group, peer, buffers)
    enc.dump(value)
    data = out.getbuffer()
    raws = [b.raw() for b in buffers]
    head = struct.pack(f"<I{len(raws)}Q", len(raws), *(r.nbytes for r in raws))
    body = torch.empty(len(head) + data.nbytes + sum(r.nbytes for r in raws),
                       dtype=torch.uint8)
    view = memoryview(body.numpy())
    off = 0
    for part in (head, data, *raws):
        n = memoryview(part).nbytes
        view[off:off + n] = part
        off += n
    return body, enc.held, enc.nccl


def decode(group: DeviceGroup, peer: int, body, cache: dict):
    """The value of a VALUE frame, and whether it held IPC tensors (then
    the caller ACKs once ``done`` has run)."""
    view = memoryview(body.numpy())
    (nbufs,) = struct.unpack("<I", view[:4])
    lens = struct.unpack(f"<{nbufs}Q", view[4:4 + 8 * nbufs])
    off = 4 + 8 * nbufs
    data_len = len(view) - off - sum(lens)
    data = view[off:off + data_len]
    off += data_len
    bufs = []
    for n in lens:
        bufs.append(view[off:off + n])
        off += n
    dec = _Decoder(io.BytesIO(data), group, peer, bufs, cache)
    value = dec.load()
    return value, dec


class DeviceChannel:
    """One edge on the graph's device group.

    Two calling modes share the instance:

    * edge mode (``push_edge``/``pop_edge``): the executor's fixed (src,
      dst, slot) identity; the wire tag is ``dagch:p{epoch}:e{src}:{dst}:
      {slot}``, and the consumer's end holds a mailbox for it, the
      producer's one for the consumer's ACKs;
    * tagged mode (``push``/``pop`` with a keyword-only ``tag``): a caller's
      own tags (one message each; an IPC push waits for its ACK).

    A producer keeps each IPC payload (the tensor and its event) until the
    consumer ACKs it, at most ``depth`` an edge. With ``wire_cfg`` and
    ``ef``, float numpy payloads cross block-scale quantized (the edge's
    (src, dst, slot), or a tagged push's ``ef_site``, keys the residual).
    """

    def __init__(self, group: DeviceGroup, peer: int, *, src: int = 0, dst: int = 0,
                 slot: int = 0, epoch: int = 0, depth: int = 8, role: str | None = None,
                 wire_cfg=None, ef=None, site: str = "dag"):
        self._group = group
        self._peer = peer
        self._wire_cfg, self._ef, self._site = wire_cfg, ef, site
        self._ef_site = (src, dst, slot)
        self._recv_seq = 0
        self.epoch = epoch
        self.depth = depth
        self.tag = f"dagch:p{epoch}:e{src}:{dst}:{slot}"
        self._data_tag = int_tag(self.tag)
        self._ack_tag = int_tag("dagack" + self.tag[5:])
        self._held: collections.deque = collections.deque()
        self._cache: dict = {}
        self._role = role
        # The trace context of the last edge pop.
        self.last_trace: dict | None = None
        self._box = None
        if role == "consumer":
            self._box = group.mailbox(peer, self._data_tag)
        elif role == "producer":
            self._box = group.mailbox(peer, self._ack_tag)

    # -- edge mode -------------------------------------------------------
    # -- codec ---------------------------------------------------------
    def _encode(self, value, ef_site):
        import numpy as np

        if (self._wire_cfg is not None and self._ef is not None and ef_site is not None
                and isinstance(value, np.ndarray) and value.dtype.kind == "f"):
            enc = self._ef.encode(ef_site, value.ravel(), self._wire_cfg)
            return (_ACT_WIRE, value.shape, value.dtype.str, enc)
        return value

    @staticmethod
    def _decode(out):
        if isinstance(out, tuple) and len(out) == 4 and out[0] == _ACT_WIRE:
            import numpy as np

            from ray_tpu_torch.util.collective.quantization import decode_plain

            _, shape, dtype_str, enc = out
            return decode_plain(enc).reshape(shape).astype(np.dtype(dtype_str))
        return out

    def _note_push(self, body) -> None:
        with flight.site(self._site):
            flight.note(self._group.name, "chan_push", tag=self.tag, rank=self._group.rank,
                        world_size=self._group.world_size, peer=self._peer,
                        nbytes=int(body.numel()))

    def _recv_record(self, tag: str):
        """A recv record the watchdog ages while this end waits."""
        with flight.site(self._site):
            rec = flight.p2p_started(self._group.name, "recv", tag, self._recv_seq,
                                     self._group.rank, self._peer, self._group.world_size)
        flight.launched(rec)
        return rec

    # -- edge mode -------------------------------------------------------
    def push_edge(self, value, stop=None, trace: dict | None = None) -> None:
        payload = self._encode(value, self._ef_site)
        ctx = _resolve_ctx(trace)
        span, wire_ctx = _push_span(ctx, channel=self.tag, family="device", seq=None, nbytes=0)
        if wire_ctx is not None:
            payload = (_TR_WIRE, wire_ctx, payload)
        body, held, nccl = encode(self._group, self._peer, payload)
        if held:
            while len(self._held) >= self.depth:
                self._take_ack(stop)
        self._group.send_frame(self._peer, self._data_tag, VALUE, body)
        for t in nccl:
            self._group.nccl.send([t], self._peer, 0).wait()
        if held:
            self._held.append(held)
        with flight.trace(ctx["trace_id"] if ctx else None):
            self._note_push(body)
        if span is not None:
            tracing.finish(span)

    def _take_ack(self, stop=None, timeout: float | None = None) -> None:
        kind, _ = self._box.get(timeout=timeout, stop=stop)
        if kind != ACK:
            raise RuntimeError(f"{self.tag}: frame kind {kind} where an ACK belongs")
        self._held.popleft()
        self._group.torch.cuda.ipc_collect()

    def pop_edge(self, *, timeout: float = 60.0, stop=None):
        # A windowed schedule makes the whole device wire slow but alive,
        # which the supervisor must tell from a death.
        extra = chaos.latency_delay("dag.device.pop")
        if extra > 0:
            time.sleep(extra)
        started = time.monotonic()
        rec = self._recv_record(self.tag)
        try:
            kind, body = self._box.get(timeout=timeout, stop=stop)
        except BaseException:
            flight.completed(rec, ok=False)
            raise
        flight.completed(rec)
        self._recv_seq += 1
        out = self._receive(body, self._ack_tag)
        if isinstance(out, tuple) and len(out) == 3 and out[0] == _TR_WIRE:
            _, ctx, out = out
            self.last_trace = ctx
            _emit_pop(ctx, started, channel=self.tag, family="device")
        else:
            self.last_trace = None
        return self._decode(out)

    def _receive(self, body, ack_tag: int):
        value, dec = decode(self._group, self._peer, body, self._cache)
        if dec.ipc:
            for done in dec.copies:
                done.synchronize()
            self._group.send_frame(self._peer, ack_tag, ACK)
        return value

    def links(self) -> list:
        """The (peer, tag)s this end sends on, to CLOSE at teardown."""
        if self._role == "producer":
            return [(self._peer, self._data_tag)]
        if self._role == "consumer":
            return [(self._peer, self._ack_tag)]
        return []

    # -- tagged mode -----------------------------------------------------
    def push(self, value, *, tag: str, ef_site=None) -> None:
        body, held, nccl = encode(self._group, self._peer, self._encode(value, ef_site))
        acks = self._group.mailbox(self._peer, int_tag("dagack:" + tag), once=True) \
            if held else None
        self._group.send_frame(self._peer, int_tag(tag), VALUE, body)
        for t in nccl:
            self._group.nccl.send([t], self._peer, 0).wait()
        if acks is not None:
            acks.get()
        self._note_push(body)

    def pop(self, *, tag: str, timeout: float = 60.0):
        box = self._group.mailbox(self._peer, int_tag(tag), once=True)
        rec = self._recv_record(tag)
        try:
            _, body = box.get(timeout=timeout)
        except BaseException:
            flight.completed(rec, ok=False)
            raise
        flight.completed(rec)
        return self._decode(self._receive(body, int_tag("dagack:" + tag)))


class LocalChannel:
    """A bounded in-process channel for asyncio producers and consumers
    (same-process streams, such as a serve replica's token stream).
    ``pop_batch`` is the batched drain a streaming call needs: one blocking
    wait, then drain without waiting."""

    def __init__(self, maxsize: int = 256, *, label: str = ""):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._label = label
        self._closed = False
        # The trace context of the last traced item drained.
        self.last_trace: dict | None = None

    async def put(self, item, trace: dict | None = None) -> None:
        if self._closed:
            raise ChannelClosedError(f"{self._label}: channel closed")
        if trace is not None:
            # The device wire's envelope: pop_batch unwraps it.
            item = (_TR_WIRE, trace, item)
        await self._q.put(item)

    def qsize(self) -> int:
        return self._q.qsize()

    async def pop_batch(self, max_items: int, timeout_s: float) -> list:
        """Blocks up to ``timeout_s`` for the first item, then drains up to
        ``max_items`` without waiting. [] on timeout."""
        items: list = []
        try:
            items.append(await asyncio.wait_for(self._q.get(), timeout_s))
        except asyncio.TimeoutError:
            return items
        while len(items) < max_items:
            try:
                items.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        unwrapped: list = []
        for item in items:
            if isinstance(item, tuple) and len(item) == 3 and item[0] == _TR_WIRE:
                self.last_trace = item[1]
                item = item[2]
            unwrapped.append(item)
        return unwrapped

    def close(self) -> None:
        self._closed = True
