"""The serve plane's wire: method calls between the port's processes.

Where the reference calls actor methods through its runtime, the port's
processes (the driver and each replica) talk over localhost TCP: a frame is
an 8-byte length and a pickle. A caller keeps one connection per peer and
multiplexes its calls on it by call id, so one connection carries every
request a process has in flight to a replica, and the replica answers them
in the order they finish. A peer that closes its end fails every call in
flight on it with ``ConnectionLost``; the handle takes that for the
replica's death.

Each process runs one I/O event loop on a thread of its own (``io_loop``):
the connections, the handle's dispatch and, in the driver, the HTTP proxy
and the controller's membership server live on it, so a thread that blocks
in ``DeploymentResponse.result()`` never blocks the loop it waits on.
Frames are unpickled only from the port's own processes on this host.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import pickle
import socket
import struct
import threading
import traceback
from typing import Any, Awaitable, Callable

_HEADER = struct.Struct("!Q")


class ConnectionLost(ConnectionError):
    """The peer's connection closed (or could not be opened) with the call
    in flight."""


class RemoteError(Exception):
    """A call raised in the peer: ``error`` is the exception (or a
    RuntimeError with its text where it did not pickle) and ``remote_traceback``
    the peer's traceback."""

    def __init__(self, error: BaseException, remote_traceback: str):
        super().__init__(f"{type(error).__name__}: {error}")
        self.error, self.remote_traceback = error, remote_traceback


# Calls this process has sent to the peers named by ``count_calls_to``,
# by (peer address, name): the name is the method, or the label of a peer
# that counts its calls apart (the membership subscriber's parked long
# poll). A replica counts its calls to the controller, which the serve-LLM
# engine's steady state probe reads; other peers are not counted.
_counted: frozenset = frozenset()
_sent: collections.Counter = collections.Counter()
_sent_lock = threading.Lock()


def count_calls_to(address) -> None:
    """Counts the calls this process sends to ``address`` from now on."""
    global _counted
    with _sent_lock:
        _counted = _counted | {tuple(address)}


def _count_sent(address: tuple, name: str) -> None:
    if address in _counted:
        with _sent_lock:
            _sent[(address, name)] += 1


def calls_sent(address) -> dict:
    """The calls this process has sent to ``address`` so far, by name."""
    key = tuple(address)
    with _sent_lock:
        return {name: n for (peer, name), n in _sent.items() if peer == key}


def frame(message: Any) -> bytes:
    data = pickle.dumps(message, protocol=pickle.HIGHEST_PROTOCOL)
    return _HEADER.pack(len(data)) + data


async def read_frame(reader: asyncio.StreamReader) -> Any:
    (size,) = _HEADER.unpack(await reader.readexactly(_HEADER.size))
    return pickle.loads(await reader.readexactly(size))


# -- the process's I/O loop --------------------------------------------------
_loop: asyncio.AbstractEventLoop | None = None
_loop_lock = threading.Lock()


def io_loop() -> asyncio.AbstractEventLoop:
    """This process's I/O loop, started on a daemon thread at first use."""
    global _loop
    with _loop_lock:
        if _loop is None:
            loop = asyncio.new_event_loop()
            ready = threading.Event()

            def run():
                asyncio.set_event_loop(loop)
                loop.call_soon(ready.set)
                loop.run_forever()

            threading.Thread(target=run, name="serve-io", daemon=True).start()
            ready.wait()
            _loop = loop
        return _loop


def on_io_thread() -> bool:
    try:
        return asyncio.get_running_loop() is _loop
    except RuntimeError:
        return False


def submit(coro: Awaitable):
    """Schedules ``coro`` on the I/O loop; returns a concurrent future."""
    return asyncio.run_coroutine_threadsafe(coro, io_loop())


def run_sync(coro: Awaitable, timeout: float | None = None) -> Any:
    """Runs ``coro`` on the I/O loop and waits for it from another thread."""
    if on_io_thread():
        coro.close()
        raise RuntimeError("a blocking serve call was made on the serve I/O loop")
    future = submit(coro)
    try:
        return future.result(timeout)
    except TimeoutError:
        future.cancel()
        raise


# -- the caller's side -------------------------------------------------------
class Peer:
    """One connection to a peer's server, shared by every call this process
    makes to it. Lives on the I/O loop."""

    def __init__(self, address: tuple[str, int]):
        self.address = tuple(address)
        self.closed = False
        self._writer: asyncio.StreamWriter | None = None
        self._connecting: asyncio.Future | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._ids = itertools.count()
        self._reader_task: asyncio.Task | None = None

    async def _connect(self) -> None:
        try:
            reader, writer = await asyncio.open_connection(*self.address)
        except OSError as exc:
            self.closed = True
            raise ConnectionLost(f"cannot connect to {self.address}: {exc}") from exc
        self._writer = writer
        self._reader_task = asyncio.get_running_loop().create_task(self._read_loop(reader))

    async def call(self, method: str, *args, **kwargs) -> Any:
        """The peer's ``method(*args, **kwargs)``; raises RemoteError for an
        exception in the peer and ConnectionLost if the peer goes away."""
        if self._writer is None and not self.closed:
            if self._connecting is None:
                self._connecting = asyncio.ensure_future(self._connect())
            await asyncio.shield(self._connecting)
        if self.closed:
            raise ConnectionLost(f"connection to {self.address} is closed")
        call_id = next(self._ids)
        future = asyncio.get_running_loop().create_future()
        self._pending[call_id] = future
        try:
            self._writer.write(frame((call_id, method, args, kwargs)))
            _count_sent(self.address, method)
            ok, payload = await future
        finally:
            self._pending.pop(call_id, None)
        if ok:
            return payload
        error, text = payload
        raise RemoteError(error, text)

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                call_id, ok, payload = await read_frame(reader)
                future = self._pending.get(call_id)
                if future is not None and not future.done():
                    future.set_result((ok, payload))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self.closed = True
            for future in self._pending.values():
                if not future.done():
                    future.set_exception(ConnectionLost(f"peer {self.address} closed"))
            self._writer.close()

    def close(self) -> None:
        """Closes the connection (on the I/O loop)."""
        self.closed = True
        if self._writer is not None:
            self._writer.close()


_peers: dict[tuple, Peer] = {}


def peer(address) -> Peer:
    """The process's connection to ``address`` (I/O loop only); a closed one
    is replaced."""
    key = tuple(address)
    found = _peers.get(key)
    if found is None or found.closed:
        found = _peers[key] = Peer(key)
    return found


class BlockingPeer:
    """One connection to a peer for a thread that may block (the membership
    subscriber): calls go one at a time, without the I/O loop. ``label``
    counts its calls under that name instead of the method's."""

    def __init__(self, address: tuple[str, int], label: str | None = None):
        self.address = tuple(address)
        self._label = label
        self._sock: socket.socket | None = None
        self._ids = itertools.count()

    def call(self, method: str, *args, timeout: float | None = None, **kwargs) -> Any:
        try:
            if self._sock is None:
                self._sock = socket.create_connection(self.address, timeout=timeout)
            self._sock.settimeout(timeout)
            call_id = next(self._ids)
            self._sock.sendall(frame((call_id, method, args, kwargs)))
            _count_sent(self.address, self._label or method)
            (size,) = _HEADER.unpack(self._recv(_HEADER.size))
            _, ok, payload = pickle.loads(self._recv(size))
        except (OSError, EOFError) as exc:
            self.close()
            if isinstance(exc, TimeoutError):
                raise
            raise ConnectionLost(f"peer {self.address}: {exc}") from exc
        if ok:
            return payload
        error, text = payload
        raise RemoteError(error, text)

    def _recv(self, size: int) -> bytes:
        data = bytearray()
        while len(data) < size:
            chunk = self._sock.recv(size - len(data))
            if not chunk:
                raise EOFError("peer closed the connection")
            data += chunk
        return bytes(data)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


# -- the peer's side ---------------------------------------------------------
async def serve_connection(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                           dispatch: Callable[[str, tuple, dict], Awaitable]) -> None:
    """Answers the calls arriving on one connection, each in a task of its
    own so that slow calls do not hold back the rest."""
    running: set[asyncio.Task] = set()

    async def answer(call_id, method, args, kwargs):
        try:
            reply = (call_id, True, await dispatch(method, args, kwargs))
        except Exception as exc:
            reply = (call_id, False, (exc, traceback.format_exc()))
        try:
            data = frame(reply)
        except Exception as exc:  # an answer or error that does not pickle
            error = RuntimeError(f"{type(exc).__name__}: {exc}")
            data = frame((call_id, False, (error, traceback.format_exc())))
        if not writer.is_closing():
            writer.write(data)

    try:
        while True:
            call_id, method, args, kwargs = await read_frame(reader)
            task = asyncio.get_running_loop().create_task(answer(call_id, method, args, kwargs))
            running.add(task)
            task.add_done_callback(running.discard)
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        pass
    finally:
        writer.close()
