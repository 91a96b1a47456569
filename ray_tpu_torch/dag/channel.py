"""Shared-memory channel primitives for compiled DAGs.

The counterpart of ray_tpu's ``dag/channel.py``: a channel is a bounded
ring of named slots, the consumer deletes the slot after reading it, and
the delete IS the backpressure release. The reference's slots live in the
node's C++ shm object store; the port has no such store (ROADMAP Queue A
item 14), so ``SlotStore`` keeps the store's slot API on files of a
directory in ``/dev/shm`` (the temporary directory where there is none):

* ``create(name, size)`` raises ``FileExistsError`` while the slot is
  occupied and hands back a writable view; ``seal(name)`` publishes it.
  ``write(name, parts, total)`` does both in one ``writev``. A slot is
  written under a private name and published by ``link``, so a reader
  never sees a partial frame and an occupied slot is never overwritten.
* ``get(name, timeout_ms)`` returns a read-only view of a sealed slot (a
  mapping of the file at or above ``ZERO_COPY_THRESHOLD``) or None;
  ``release`` drops a reader's pin (a mapping needs none: it stays valid
  after the file is gone); ``delete`` frees the name.

One store directory serves a driver and the actors it started
(``ray_tpu_torch_dag_<pid>_<hex>``). A graph's teardown deletes its slots,
the driver's exit removes the directory, and a directory whose driver is
gone (killed) is removed by the next store a driver makes on the host, as
``_private.local_tasks`` sweeps an orphaned object store.

Values travel as stdlib pickle (protocol 5) with their out-of-band
buffers after it, each part at a 64-byte boundary. Payloads at or above
``ZERO_COPY_THRESHOLD`` deserialize as zero-copy, READ-ONLY views onto the
slot's mapping (numpy arrays), and the slot frees when the VALUE is
garbage-collected (backpressure then tracks the value's lifetime); a
stage that writes its input in place copies it first. A CUDA tensor is
refused here (``TypeError``): a host channel never moves a card's tensor
through the host, a device edge carries it (``channels.DeviceChannel``).

Seq framing is the reference's: each slot carries an ``(epoch, seq)``
header and one trace-length byte (always 0: trace-context segments are
ROADMAP item 14), so a consumer that polls a slot verifies it holds the
seq it expects, and a frame written before a recovery's epoch bump is
discarded and counted (``stale_frame_count``) instead of desequencing the
re-opened ring.
"""

from __future__ import annotations

import atexit
import glob
import io
import mmap
import os
import pickle
import shutil
import struct
import sys
import tempfile
import threading
import time
import uuid
import weakref

# Payloads at or above this deserialize as zero-copy views onto the slot;
# the slot is freed when the value dies (non-weakref-able values, dicts and
# tuples, pay a copying deserialize instead).
ZERO_COPY_THRESHOLD = 256 * 1024

STORE_PREFIX = "ray_tpu_torch_dag_"
_MAGIC = b"RTD5"
_HEAD = struct.Struct("<4sIQ")
_ALIGN = 64
_ZEROS = bytes(_ALIGN)


def slot_name(base: str, seq: int, depth: int) -> str:
    return f"{base}-{seq % depth}"


# ------------------------------------------------------------ serialization
def _is_cuda_tensor(obj) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(obj, torch.Tensor) and obj.is_cuda


class _HostPickler(pickle.Pickler):
    """Refuses a CUDA tensor anywhere in the value: pickling one would copy
    it through the host."""

    def persistent_id(self, obj):
        if _is_cuda_tensor(obj):
            raise TypeError(
                "a CUDA tensor cannot ride a host channel (shm or socket): it "
                "would move through the host; compile the edge with "
                "channel='device'")
        return None


def _pad(n: int) -> int:
    return -n % _ALIGN


def serialize_parts(value) -> tuple[list, int]:
    """(parts, total bytes): a header, the pickle and each out-of-band
    buffer, every part padded to a 64-byte boundary."""
    buffers: list = []
    out = io.BytesIO()
    _HostPickler(out, protocol=5, buffer_callback=buffers.append).dump(value)
    data = out.getbuffer()
    raws = [b.raw() for b in buffers]
    head = _HEAD.pack(_MAGIC, len(raws), data.nbytes) + b"".join(
        struct.pack("<Q", r.nbytes) for r in raws)
    parts, total = [], 0
    for part in (head, data, *raws):
        n = part.nbytes if isinstance(part, memoryview) else len(part)
        parts.append(part)
        if _pad(n):
            parts.append(_ZEROS[:_pad(n)])
        total += n + _pad(n)
    return parts, total


def serialize(value) -> bytes:
    parts, _ = serialize_parts(value)
    return b"".join(parts)


def deserialize(view, zero_copy: bool = False):
    """The value of ``serialize``'s bytes; with ``zero_copy`` its buffers
    are views of ``view`` (read-only when ``view`` is)."""
    view = memoryview(view)
    magic, nbufs, nbytes = _HEAD.unpack(view[:_HEAD.size])
    if magic != _MAGIC:
        raise ValueError("not a frame of this channel")
    lens = struct.unpack(f"<{nbufs}Q", view[_HEAD.size:_HEAD.size + 8 * nbufs])
    offset = _HEAD.size + 8 * nbufs
    offset += _pad(offset)
    data = view[offset:offset + nbytes]
    offset += nbytes + _pad(nbytes)
    bufs = []
    for n in lens:
        buf = view[offset:offset + n]
        bufs.append(buf if zero_copy else bytearray(buf))
        offset += n + _pad(n)
    return pickle.loads(data, buffers=bufs)


# ------------------------------------------------------------------ store
def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _remove_orphans(root: str) -> None:
    """Removes the store directories under ``root`` whose driver is gone."""
    for path in glob.glob(os.path.join(root, STORE_PREFIX + "*")):
        try:
            pid = int(os.path.basename(path)[len(STORE_PREFIX):].split("_")[0])
        except ValueError:
            continue
        if pid != os.getpid() and not _pid_alive(pid):
            shutil.rmtree(path, ignore_errors=True)


def _shm_root() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK) \
        else tempfile.gettempdir()


class SlotStore:
    """Named slots, as files of one directory (module docstring)."""

    def __init__(self, root: str):
        self.root = root
        self._open: dict[str, tuple] = {}  # name -> (private path, fd, mapping)
        self._lock = threading.Lock()

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _private(self, name: str) -> str:
        return f"{self._path(name)}.{os.getpid()}.{threading.get_ident()}.w"

    def create(self, name: str, size: int) -> memoryview:
        if os.path.exists(self._path(name)):
            raise FileExistsError(name)
        private = self._private(name)
        fd = os.open(private, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
        os.ftruncate(fd, max(size, 1))
        mapping = mmap.mmap(fd, max(size, 1))
        with self._lock:
            self._open[name] = (private, fd, mapping)
        return memoryview(mapping)[:size]

    def seal(self, name: str) -> None:
        with self._lock:
            private, fd, mapping = self._open.pop(name)
        try:
            mapping.close()
        except BufferError:
            pass  # a caller's view still holds it; the file is complete all the same
        os.close(fd)
        self._publish(private, name)

    def write(self, name: str, parts, total: int) -> bool:
        """create + fill + seal in one ``writev``; False while occupied."""
        path = self._path(name)
        if os.path.exists(path):
            return False
        private = self._private(name)
        fd = os.open(private, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o600)
        try:
            written, i = 0, 0
            parts = list(parts)
            while i < len(parts):
                n = os.writev(fd, parts[i:i + 512])
                written += n
                # writev may stop short: resume inside the part it stopped in.
                while i < len(parts) and n >= memoryview(parts[i]).nbytes:
                    n -= memoryview(parts[i]).nbytes
                    i += 1
                if n:
                    parts[i] = memoryview(parts[i])[n:]
        finally:
            os.close(fd)
        if written != total:
            os.unlink(private)
            raise RuntimeError(f"slot {name}: wrote {written} of {total} bytes")
        try:
            self._publish(private, name)
        except FileExistsError:
            return False
        return True

    def _publish(self, private: str, name: str) -> None:
        try:
            os.link(private, self._path(name))
        finally:
            os.unlink(private)

    def get(self, name: str, timeout_ms: int = 0):
        """A read-only view of the sealed slot, or None when it is absent
        after ``timeout_ms``."""
        deadline = time.monotonic() + timeout_ms / 1000.0
        delay = 0.0005
        while True:
            try:
                fd = os.open(self._path(name), os.O_RDONLY)
                break
            except FileNotFoundError:
                if time.monotonic() >= deadline:
                    return None
                time.sleep(delay)
                delay = min(delay * 2, 0.01)
        try:
            size = os.fstat(fd).st_size
            if size >= ZERO_COPY_THRESHOLD:
                return memoryview(mmap.mmap(fd, size, access=mmap.ACCESS_READ))
            chunks, left = [], size
            while left:
                chunk = os.read(fd, left)
                if not chunk:
                    break
                chunks.append(chunk)
                left -= len(chunk)
            return memoryview(b"".join(chunks))
        finally:
            os.close(fd)

    def release(self, name: str) -> None:
        """A reader's pin: a mapping stays valid after its file is deleted,
        so there is nothing to drop."""

    def delete(self, name: str) -> None:
        os.unlink(self._path(name))

    def list(self) -> list[str]:
        try:
            return sorted(n for n in os.listdir(self.root) if not n.endswith(".w"))
        except FileNotFoundError:
            return []


_local: SlotStore | None = None
_local_lock = threading.Lock()


def local_store() -> SlotStore:
    """This driver's store, made (and orphans swept) on first use."""
    global _local
    with _local_lock:
        if _local is None:
            root = _shm_root()
            _remove_orphans(root)
            path = os.path.join(root, f"{STORE_PREFIX}{os.getpid()}_{uuid.uuid4().hex[:8]}")
            os.makedirs(path)
            _local = SlotStore(path)
            atexit.register(remove_local_store)
        return _local


def remove_local_store() -> None:
    """Removes this driver's store directory (its graphs are torn down)."""
    global _local
    with _local_lock:
        store, _local = _local, None
    if store is not None:
        shutil.rmtree(store.root, ignore_errors=True)


# ------------------------------------------------------------- ring slots
def try_write(store: SlotStore, name: str, parts, total: int) -> bool:
    """One streamed write attempt; False when the ring slot is still
    occupied (consumer behind: the caller waits and retries)."""
    return store.write(name, parts, total)


def _free_slot(store: SlotStore, name: str) -> None:
    try:
        store.release(name)
        store.delete(name)
    except OSError:
        pass  # already freed by the peer or the teardown


def _consume_view(store: SlotStore, name: str, view):
    if view.nbytes >= ZERO_COPY_THRESHOLD:
        value = deserialize(view, zero_copy=True)
        try:
            weakref.finalize(value, _free_slot, store, name)
            return value
        except TypeError:
            pass  # not weakref-able: copy out below
    try:
        return deserialize(view, zero_copy=False)
    finally:
        _free_slot(store, name)


def read_consume(store: SlotStore, name: str, timeout_ms: int = 60_000):
    """Blocking read of a slot, then free it (the producer unblocks)."""
    view = store.get(name, timeout_ms=timeout_ms)
    if view is None:
        raise TimeoutError(f"channel slot {name} never arrived")
    return _consume_view(store, name, view)


SEQ_HEADER = struct.Struct("<QQ")  # (epoch, seq)
_NO_TRACE = b"\x00"

# Distinguishes "slot not written yet" from any payload value (None too).
NOT_READY = object()

# Every discarded pre-recovery frame bumps this (tests and the recovery
# benchmark read it).
_stale_frames = 0


def stale_frame_count() -> int:
    return _stale_frames


def try_write_seq(store: SlotStore, name: str, seq: int, parts, total: int,
                  epoch: int = 0) -> bool:
    """One seq-framed write attempt; False while the ring slot still holds
    an unconsumed earlier seq."""
    header = SEQ_HEADER.pack(epoch, seq)
    return try_write(store, name, [header, _NO_TRACE, *parts],
                     total + SEQ_HEADER.size + len(_NO_TRACE))


def read_seq_consume(store: SlotStore, name: str, seq: int, epoch: int = 0):
    """Non-blocking epoch+seq-framed read. NOT_READY when the slot is
    absent or holds a stale-epoch frame (consumed and counted, so the
    replaying producer can claim the slot); otherwise the slot's value."""
    global _stale_frames
    view = store.get(name, timeout_ms=0)
    if view is None:
        return NOT_READY
    if view.nbytes < SEQ_HEADER.size + 1:
        _free_slot(store, name)
        raise RuntimeError(f"channel slot {name}: truncated seq header")
    got_epoch, got = SEQ_HEADER.unpack(view[:SEQ_HEADER.size])
    if got_epoch != epoch:
        _free_slot(store, name)
        if got_epoch < epoch:
            _stale_frames += 1
            return NOT_READY
        raise RuntimeError(
            f"channel slot {name}: frame epoch {got_epoch} is ahead of this "
            f"consumer's epoch {epoch} (reader missed a recovery)")
    if got != seq:
        _free_slot(store, name)
        raise RuntimeError(f"channel slot {name}: seq desync (holds {got}, expected {seq})")
    body = SEQ_HEADER.size + 1 + view[SEQ_HEADER.size]
    return _consume_view(store, name, view[body:])
