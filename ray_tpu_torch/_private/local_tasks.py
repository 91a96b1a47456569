"""The local task, actor and object layer that ``ray_tpu_torch.data`` runs on.

The data package of ray_tpu calls its runtime for tasks, actors and
objects (``ray_tpu.remote``, ``get``, ``wait``, ``put``, ``kill``). The port
has no runtime (ROADMAP Queue A item 14), so this module gives the data
package those calls on one host, and nothing more:

* ``remote(fn)`` and ``remote(num_returns=n)(fn)`` make a function a task:
  ``fn.remote(*args)`` returns an ``ObjectRef`` (a list of ``n`` with
  ``num_returns=n``, whose task returns a sequence of ``n``), and
  ``fn.options(num_returns=n)`` sets it for one call. An ``ObjectRef``
  among the top-level arguments is replaced by its value before the task
  runs, and the task runs only once every such argument is ready; a failed
  argument fails the task with the argument's error.
* ``remote(cls)`` makes an actor class: ``cls.remote(*args)`` starts one
  process that holds the instance, and ``handle.method.remote(*args)``
  runs the method there, one call after the other, in submission order.
  ``cls.options(num_cpus=, num_gpus=, resources=, max_restarts=)`` sets
  what the actor leases from this host's ledger (``_private.resources``,
  the reference's ``num_cpus``/``num_tpus``/``resources`` with ``GPU`` for
  ``TPU``) and how often it is restarted after a death it did not ask for.
  The lease is taken when the actor starts (a request the host can never
  hold raises ``InfeasibleResourcesError`` there; one that does not fit
  now waits, the actor ``PENDING``) and given back when the actor is
  killed or dies for good. An actor without options leases nothing.
* Each actor has an id (``handle._actor_id``) and a state (``PENDING``,
  ``ALIVE``, ``RESTARTING`` or ``DEAD``: ``actor_info``), and
  ``restart_actor`` starts a new process of a dead actor from the same
  class and constructor arguments under the same id: the counterparts of
  the controller's ``get_actor_info`` and ``restart_actor``, which compiled
  graphs (``ray_tpu_torch.dag``) place and heal their actors by.
  ``handle.method.bind(*args)`` makes a graph node of a method.
* ``get(refs, timeout=)``, ``wait(refs, num_returns=, timeout=)``,
  ``put(value)`` and ``kill(actor)`` keep the reference's meaning. A task
  or actor method that raised makes ``get`` raise ``TaskError`` with the
  worker's traceback.

Workers. Tasks run on a pool of worker processes (``multiprocessing``'s
spawn context), started once per submitting process and reused; an actor is
one dedicated process of its own. They start with ``CUDA_VISIBLE_DEVICES``
empty: a data worker never opens a CUDA context on the card the trainer
uses. Only an actor that leased ``GPU`` starts with the lease's cards
visible (two actors at 0.5 see the one card they share). A worker that
dies fails the task it ran (``WorkerCrashedError``) and is replaced.

An actor process also listens on a local socket for the messages that
ray_tpu's worker answers for compiled graphs (``worker_proc.py``'s
``rpc_dag_*``): register (builds the graph's ``DagRuntime``), teardown,
snapshot and restore (``__dag_snapshot__`` / ``__dag_restore__``), and the
socket family's push and pop. Its ordinary calls and its graph stages run
the instance's methods one at a time, under one lock: the reference's
single-width actor executor. ``actor_messages()`` counts the messages this
process has sent to actors (calls and graph messages alike).

Objects live in the submitting process's store, a directory of files
under the temporary directory (``ray_tpu_torch_store_<pid>_<hex>``), each
a stdlib pickle (protocol 5) whose out-of-band buffers follow it in the
file: a reader maps the file and numpy arrays come back as read-only views
of the mapping, with no copy. An ``ObjectRef`` is a small picklable value
(an id and the file's path), so a ref handed to another process (a gang
member's ``DataIterator``) is read there from the same file; ``get`` in a
process that did not make the ref waits for the file. The process that
made a ref counts its handles to each object and removes the file when the
last is gone, as the reference's runtime frees what nothing references;
a store's directory
goes at ``shutdown()`` and at the process's exit, and a store whose
process is gone (killed) is removed by the next store started on the host.

Functions, actor classes and UDFs go to workers as stdlib pickle does them,
by module and qualified name (as the port's Tune trainables and serve
deployments do): a lambda or a function defined inside another function is
refused when its task is submitted, with a ``TypeError`` that says so. It
never runs in the submitting process instead.

This is not a public ``ray_tpu_torch.remote``: that is item 14's runtime.
"""

from __future__ import annotations

import atexit
import collections
import glob
import itertools
import mmap
import multiprocessing
import os
import pickle
import queue
import shutil
import struct
import sys
import tempfile
import threading
import time
import traceback
import uuid
from typing import Any, Iterable

from ray_tpu_torch.util import tracing

STORE_PREFIX = "ray_tpu_torch_store_"
# File layout: magic, buffer count, pickle length, each buffer's length;
# then the pickle, then each buffer, every part at a 64-byte boundary.
_MAGIC = b"RTT5"
_HEAD = struct.Struct("<4sIQ")
_ALIGN = 64
_PICKLE_RULE = (
    "functions, actor classes and UDFs go to worker processes by module and "
    "qualified name (stdlib pickle): a lambda or a function or class defined "
    "inside another function cannot; define it at module level and bind "
    "arguments with functools.partial")


class TaskError(RuntimeError):
    """A task or actor method raised; ``worker_traceback`` holds the
    worker's traceback."""

    def __init__(self, name: str, error: str, worker_traceback: str = ""):
        super().__init__(f"{name} raised {error}\n{worker_traceback}")
        self.task_name, self.error, self.worker_traceback = name, error, worker_traceback

    def __reduce__(self):
        return (type(self), (self.task_name, self.error, self.worker_traceback))


class WorkerCrashedError(TaskError):
    """The worker or actor process running the task died."""


class GetTimeoutError(TimeoutError):
    """``get`` waited its timeout for an object."""


# ------------------------------------------------------------------ objects
def _pad(n: int) -> int:
    return -n % _ALIGN


def _write_object(path: str, value: Any) -> int:
    """Writes ``value`` to ``path`` (a temporary name, then a rename) and
    returns the file's size."""
    buffers: list = []
    data = pickle.dumps(value, protocol=5, buffer_callback=buffers.append)
    raws = [b.raw() for b in buffers]
    head = _HEAD.pack(_MAGIC, len(raws), len(data)) + b"".join(
        struct.pack("<Q", len(r)) for r in raws)
    tmp = f"{path}.{os.getpid()}.tmp"
    size = 0
    with open(tmp, "wb") as f:
        for part in (head, data, *raws):
            f.write(part)
            f.write(b"\0" * _pad(len(part)))
            size += len(part) + _pad(len(part))
    os.replace(tmp, path)
    return size


def _read_object(path: str) -> Any:
    with open(path, "rb") as f:
        magic, nbufs, nbytes = _HEAD.unpack(f.read(_HEAD.size))
        if magic != _MAGIC:
            raise ValueError(f"{path} is not an object of this store")
        lens = struct.unpack(f"<{nbufs}Q", f.read(8 * nbufs)) if nbufs else ()
        offset = _HEAD.size + 8 * nbufs
        offset += _pad(offset)
        if not nbufs:
            f.seek(offset)
            return pickle.loads(f.read(nbytes))
        view = memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))
    data = view[offset:offset + nbytes]
    offset += nbytes + _pad(nbytes)
    bufs = []
    for n in lens:
        bufs.append(view[offset:offset + n])
        offset += n + _pad(n)
    return pickle.loads(data, buffers=bufs)


def _err_path(path: str) -> str:
    return path + ".err"


class ObjectRef:
    """A handle to one object of a store: its id and its file's path.
    Picklable; the process that made it counts its handles to free the
    object when the last goes."""

    __slots__ = ("id", "path", "__weakref__")

    def __init__(self, id: str, path: str):
        self.id, self.path = id, path
        rt = _runtime
        if rt is not None:
            rt.store.incref(self)

    def __reduce__(self):
        return (ObjectRef, (self.id, self.path))

    def __del__(self):
        rt = _runtime
        if rt is not None:
            try:
                rt.store.decref(self)
            except Exception:  # rtlint: disable=swallowed-exception - interpreter shutdown may have torn the store down
                pass

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return f"ObjectRef({self.id})"


class _Store:
    """One process's object directory: writes, reads, used bytes, and the
    handle counts that free an object's file."""

    def __init__(self, root: str | None = None):
        root = root or tempfile.gettempdir()
        _remove_orphans(root)
        self.dir = os.path.join(root, f"{STORE_PREFIX}{os.getpid()}_{uuid.uuid4().hex[:8]}")
        os.makedirs(self.dir)
        self.capacity = shutil.disk_usage(self.dir).free
        self._lock = threading.RLock()
        self._refs: collections.Counter = collections.Counter()
        self._sizes: dict[str, int] = {}
        self._freed: set[str] = set()
        self.used = 0

    def owns(self, ref: ObjectRef) -> bool:
        return os.path.dirname(ref.path) == self.dir

    def new_ref(self) -> ObjectRef:
        oid = uuid.uuid4().hex
        return ObjectRef(oid, os.path.join(self.dir, oid))

    def incref(self, ref: ObjectRef) -> None:
        if self.owns(ref):
            with self._lock:
                self._refs[ref.id] += 1
                self._freed.discard(ref.id)

    def decref(self, ref: ObjectRef) -> None:
        if not self.owns(ref):
            return
        with self._lock:
            self._refs[ref.id] -= 1
            if self._refs[ref.id] > 0:
                return
            del self._refs[ref.id]
            if ref.id in self._sizes:
                self._unlink(ref)
            else:
                self._freed.add(ref.id)

    def sealed(self, ref: ObjectRef, size: int) -> None:
        """A worker (or this process) wrote ``ref``'s file."""
        with self._lock:
            self._sizes[ref.id] = size
            self.used += size
            if ref.id in self._freed:
                self._freed.discard(ref.id)
                self._unlink(ref)

    def _unlink(self, ref: ObjectRef) -> None:
        self.used -= self._sizes.pop(ref.id, 0)
        for path in (ref.path, _err_path(ref.path)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    def stats(self) -> dict:
        return {"used": self.used, "capacity": self.capacity}

    def remove(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _remove_orphans(root: str) -> None:
    """Removes the stores under ``root`` whose process is gone."""
    for path in glob.glob(os.path.join(root, STORE_PREFIX + "*")):
        try:
            pid = int(os.path.basename(path)[len(STORE_PREFIX):].split("_")[0])
        except ValueError:
            continue
        if pid != os.getpid() and not _pid_alive(pid):
            shutil.rmtree(path, ignore_errors=True)


# ------------------------------------------------------------------ workers
def _resolve_args(args: tuple, kwargs: dict) -> tuple:
    args = tuple(_get_one(a, None) if isinstance(a, ObjectRef) else a for a in args)
    kwargs = {k: _get_one(v, None) if isinstance(v, ObjectRef) else v
              for k, v in kwargs.items()}
    return args, kwargs


def _write_outputs(value: Any, outs: list[str]) -> list[int]:
    values = [value] if len(outs) == 1 else list(value)
    if len(values) != len(outs):
        raise ValueError(f"the task returned {len(values)} values for num_returns={len(outs)}")
    return [_write_object(path, v) for path, v in zip(outs, values)]


class _ActorProcess:
    """What an actor process holds: its instance, the lock its calls and
    graph stages run under, and its compiled graphs' runtimes by id."""

    instance: Any = None
    lock = threading.RLock()
    dags: dict = {}
    dags_lock = threading.Lock()


def _worker_main(conn, visible: str = "", actor: bool = False) -> None:
    """A pool worker or an actor: runs what its feeding thread sends, one message at
    a time, and answers each with ("ok", sizes) or ("error", error, traceback). An
    actor also serves graph messages on a local socket (``_serve_control``)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    address = _serve_control() if actor else None
    conn.send(("ready", os.getpid(), address))
    while True:
        try:
            message = conn.recv_bytes()
        except (EOFError, OSError):
            return
        try:
            kind, fn, args, kwargs, outs = pickle.loads(message)
            if kind == "stop":
                if actor:
                    _stop_actor_process()
                return
            args, kwargs = _resolve_args(args, kwargs)
            if kind == "init":
                _ActorProcess.instance = fn(*args, **kwargs)
                reply = ("ok", [])
            elif kind == "call":
                with _ActorProcess.lock:
                    value = getattr(_ActorProcess.instance, fn)(*args, **kwargs)
                reply = ("ok", _write_outputs(value, outs))
            else:
                reply = ("ok", _write_outputs(fn(*args, **kwargs), outs))
        except Exception as exc:
            reply = ("error", f"{type(exc).__name__}: {exc}", traceback.format_exc())
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            return


# ------------------------------------------------------------ graph messages
def _stop_actor_process() -> None:
    """Tears down the actor's graphs and ends the process at once: a graph's
    device group leaves gloo threads that would abort the interpreter's
    own finalization."""
    with _ActorProcess.dags_lock:
        runtimes, _ActorProcess.dags = list(_ActorProcess.dags.values()), {}
    for runtime in runtimes:
        runtime.stop()
    sys.stdout.flush()
    sys.stderr.flush()
    tracing.flush()  # a graph's spans
    os._exit(0)


def _serve_control() -> str:
    """Listens on an abstract local socket for graph messages, a thread a
    connection; returns the address. Peers authenticate with the key every
    process of this driver shares (``multiprocessing``'s authkey)."""
    from multiprocessing.connection import Listener

    address = f"\0ray_tpu_torch-actor-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    listener = Listener(address, family="AF_UNIX",
                        authkey=multiprocessing.current_process().authkey)

    def accept():
        while True:
            try:
                conn = listener.accept()
            except Exception:  # rtlint: disable=swallowed-exception - a failed handshake ends that connection only
                continue
            threading.Thread(target=_serve_connection, args=(conn,), daemon=True,
                             name="actor-control").start()

    threading.Thread(target=accept, daemon=True, name="actor-control-accept").start()
    return address


def _serve_connection(conn) -> None:
    while True:
        try:
            op, payload = conn.recv()
        except (EOFError, OSError):
            return
        try:
            reply = _CONTROL_OPS[op](payload)
        except Exception:
            reply = {"status": "error", "error": traceback.format_exc()}
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            return


def _run_stage(method: str, args: list):
    """One graph stage's call, under the lock the actor's calls take."""
    with _ActorProcess.lock:
        return getattr(_ActorProcess.instance, method)(*args)


def _dag_register(payload: dict) -> dict:
    from ray_tpu_torch.dag.executor import DagRuntime

    dag_id, epoch = payload["dag_id"], int(payload.get("epoch", 0))
    with _ActorProcess.dags_lock:
        existing = _ActorProcess.dags.get(dag_id)
        if existing is not None and existing.epoch >= epoch:
            return {"status": "ok"}  # a repeated register
        _ActorProcess.dags.pop(dag_id, None)
    if existing is not None:
        # A survivor of a recovery rebuilds its loops on the re-opened channels.
        existing.stop()
    runtime = DagRuntime(dag_id=dag_id, payload=payload, run_stage=_run_stage,
                         send_socket=_send_socket)
    with _ActorProcess.dags_lock:
        _ActorProcess.dags[dag_id] = runtime
    return {"status": "ok"}


def _send_socket(address: str, payload: dict) -> dict:
    """A socket-family push from this actor to the stage's actor."""
    return _control_client(address).call("dag_push", payload, timeout=300.0)


def _dag_teardown(payload: dict) -> dict:
    with _ActorProcess.dags_lock:
        runtime = _ActorProcess.dags.pop(payload["dag_id"], None)
    if runtime is not None:
        runtime.stop()
    return {"status": "ok"}


def _dag_runtime(dag_id: str):
    with _ActorProcess.dags_lock:
        return _ActorProcess.dags.get(dag_id)


def _dag_push(payload: dict) -> dict:
    """Socket-family delivery: feeds one buffered input slot."""
    runtime = _dag_runtime(payload["dag_id"])
    if runtime is None:
        return {"status": "error", "error": f"dag {payload['dag_id']} not registered"}
    if int(payload.get("epoch", 0)) != runtime.epoch:
        return {"status": "stale_epoch", "epoch": runtime.epoch}
    from ray_tpu_torch.dag import channel

    value = channel.deserialize(payload["value"], zero_copy=False)
    if payload.get("trace") is not None:
        from ray_tpu_torch.dag.channels import _TR_WIRE

        value = (_TR_WIRE, payload["trace"], value)
    try:
        runtime.feed(payload["node"], payload["slot"], payload["seq"], value)
    except KeyError as exc:
        return {"status": "error", "error": str(exc)}
    return {"status": "ok"}


def _dag_pop(payload: dict) -> dict:
    """Socket-family output: waits for the parked result of one seq."""
    runtime = _dag_runtime(payload["dag_id"])
    if runtime is None:
        return {"status": "error", "error": f"dag {payload['dag_id']} not registered"}
    return runtime.pop(payload["seq"], payload.get("timeout", 300.0))


def _dag_snapshot(payload: dict) -> dict:
    """``__dag_snapshot__`` of the instance, under the calls' lock; ``no_hook``
    lets a stateless stage take part in an all-or-nothing snapshot."""
    hook = getattr(_ActorProcess.instance, "__dag_snapshot__", None)
    if hook is None:
        return {"status": "no_hook"}
    with _ActorProcess.lock:
        state = hook()
    return {"status": "ok", "blob": pickle.dumps(state, protocol=5)}


def _dag_restore(payload: dict) -> dict:
    hook = getattr(_ActorProcess.instance, "__dag_restore__", None)
    if hook is None:
        return {"status": "no_hook"}
    with _ActorProcess.lock:
        hook(pickle.loads(payload["blob"]))
    return {"status": "ok"}


_CONTROL_OPS = {
    "ping": lambda payload: {"status": "ok", "pid": os.getpid()},
    "dag_register": _dag_register, "dag_teardown": _dag_teardown,
    "dag_push": _dag_push, "dag_pop": _dag_pop,
    "dag_snapshot": _dag_snapshot, "dag_restore": _dag_restore,
}


class _ControlClient:
    """Requests to one actor's graph socket: a connection a caller at a
    time (a pop that waits does not hold up a push to the same actor)."""

    def __init__(self, address: str):
        self.address = address
        self._idle: list = []
        self._lock = threading.Lock()

    def call(self, op: str, payload: dict, timeout: float = 60.0) -> dict:
        from multiprocessing.connection import Client

        with self._lock:
            conn = self._idle.pop() if self._idle else None
        if conn is None:
            conn = Client(self.address, family="AF_UNIX",
                          authkey=multiprocessing.current_process().authkey)
        try:
            conn.send((op, payload))
            if not conn.poll(timeout):
                raise TimeoutError(f"{op} to {self.address[1:]} timed out after {timeout} s")
            reply = conn.recv()
        except BaseException:
            conn.close()  # its reply, if any, belongs to no one now
            raise
        with self._lock:
            self._idle.append(conn)
        return reply

    def close(self) -> None:
        with self._lock:
            conns, self._idle = self._idle, []
        for conn in conns:
            conn.close()


_clients: dict[str, _ControlClient] = {}
_clients_lock = threading.Lock()


def _control_client(address: str) -> _ControlClient:
    with _clients_lock:
        client = _clients.get(address)
        if client is None:
            client = _clients[address] = _ControlClient(address)
        return client


def _spawn(name: str, visible: str = "", actor: bool = False):
    """A worker process with ``CUDA_VISIBLE_DEVICES`` set to ``visible`` (empty:
    no card) from its start."""
    from ray_tpu_torch._private import resources

    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_worker_main, args=(child, visible, actor), name=name,
                       daemon=True)
    with resources.child_visible_devices(visible):
        proc.start()
    child.close()
    return proc, parent


class _Task:
    """A submitted task. It holds its ref arguments (``deps``) until it
    ends, so that their objects outlive the caller's handles to them."""

    __slots__ = ("name", "message", "outs", "deps", "waiting", "target")

    def __init__(self, name: str, message: bytes, outs: list, deps: list):
        self.name, self.message, self.outs, self.deps = name, message, outs, deps
        self.waiting, self.target = 0, None


_STOP = object()
_STOP_MESSAGE = pickle.dumps(("stop", None, (), {}, []))


class _Executor:
    """One process (a pool worker or an actor) and the thread here that
    feeds it tasks from ``tasks`` and reports each outcome."""

    def __init__(self, runtime: "_Runtime", name: str, tasks: queue.Queue):
        self.runtime, self.name, self.tasks = runtime, name, tasks
        self.proc, self.conn = _spawn(name)
        self.dead: str | None = None
        self.ready = threading.Event()  # set when the process has started
        self.ready_at = 0.0
        self.thread = threading.Thread(target=self._loop, name=f"{name}-feed", daemon=True)
        self.thread.start()

    def _await_ready(self) -> None:
        try:
            self.conn.recv()  # ("ready", pid), the process's first message
        except (EOFError, OSError):
            pass  # a process that died at its start fails its first task
        self.ready_at = time.perf_counter()
        self.ready.set()

    def _loop(self) -> None:
        """The only thread that writes to this process's pipe."""
        self._await_ready()
        while True:
            task = self.tasks.get()
            if task is _STOP:
                try:
                    self.conn.send_bytes(_STOP_MESSAGE)
                except OSError:
                    pass  # the process is gone
                return
            if self.dead is not None or self.runtime.stopping:
                self.runtime.fail(task, WorkerCrashedError(
                    task.name, self.dead or "the runtime shut down"))
                continue
            try:
                self.conn.send_bytes(task.message)
                reply = self.conn.recv()
            except (EOFError, OSError):
                self.proc.join(1.0)
                self.runtime.fail(task, WorkerCrashedError(
                    task.name, f"its process {self.name} ended (exit code {self.proc.exitcode})"))
                if not self.runtime.stopping:
                    self.died()
                continue
            if reply[0] == "ok":
                self.runtime.complete(task, reply[1])
            else:
                self.runtime.fail(task, TaskError(task.name, reply[1], reply[2]))

    def died(self) -> None:
        """A pool worker that died is replaced."""
        self.conn.close()
        self.proc, self.conn = _spawn(self.name)
        self._await_ready()

    def reap(self, deadline: float) -> None:
        """After a _STOP was queued for this process's thread: waits for the
        process until ``deadline``, kills it if it is still running (a task
        that does not end), and closes the pipe."""
        self.proc.join(max(0.0, deadline - time.monotonic()))
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        self.thread.join(5.0)
        self.conn.close()


_RESTART = object()
# How often an idle actor's feeding thread looks whether its process still runs.
_WATCH_S = 0.25


class _ActorExecutor:
    """An actor: its id, state, lease and process, and the thread here that
    leases, starts (and restarts) the process and feeds it calls in order.

    States, as the controller's actor table has them: PENDING (waiting for
    its lease or starting), ALIVE (its constructor ran), RESTARTING and DEAD.
    A death the actor did not ask for restarts it while ``max_restarts``
    allows (-1: always); ``kill(no_restart=True)`` and a failed constructor
    are final until ``restart_actor``."""

    def __init__(self, runtime: "_Runtime", name: str, actor_id: str, bundle: dict,
                 lease, max_restarts: int):
        self.runtime, self.name, self.actor_id = runtime, name, actor_id
        self.tasks: queue.Queue = queue.Queue()
        self.bundle, self.lease, self.max_restarts = bundle, lease, int(max_restarts)
        self.restarts = 0
        self.proc = self.conn = None
        self.address: str | None = None
        self.state = "PENDING"
        self.dead: str | None = None  # why, while DEAD
        self.no_restart = False
        self.generation = 0  # one a process
        self.init_task: _Task | None = None
        self.init_ref: ObjectRef | None = None
        self.cond = threading.Condition()
        self.thread = threading.Thread(target=self._loop, name=f"{name}-feed", daemon=True)
        self.thread.start()

    # -- state ---------------------------------------------------------------
    def info(self) -> dict:
        """The controller's ``get_actor_info``: state, pid, address, cause."""
        self.check()
        with self.cond:
            return self._info_locked()

    def _info_locked(self) -> dict:
        return {"state": self.state, "pid": self.proc.pid if self.proc else None,
                "address": self.address, "death_cause": self.dead,
                "restarts": self.restarts}

    def wait_ready(self, timeout: float) -> dict:
        """Waits until the actor is ALIVE or DEAD (at most ``timeout`` s),
        through RESTARTING: a death not yet noticed is noticed first, so an
        ALIVE actor whose process has ended is waited on, not returned."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while True:
                self.check()
                if self.state in ("ALIVE", "DEAD"):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self.cond.wait(min(left, _WATCH_S))
            return self._info_locked()

    def check(self) -> None:
        """Notices a process that ended while the actor was idle."""
        proc, gen = self.proc, self.generation
        if proc is not None and self.state == "ALIVE" and proc.exitcode is not None:
            self._died(gen, f"the actor process {self.name} ended (exit code "
                            f"{proc.exitcode})")

    def _set(self, state: str, dead: str | None = None) -> None:
        with self.cond:
            self.state, self.dead = state, dead
            self.cond.notify_all()

    def _died(self, gen: int, cause: str) -> None:
        """The process of generation ``gen`` ended while ALIVE (or before its
        first constructor answered): its death counts once."""
        with self.cond:
            if gen != self.generation or self.state in ("DEAD", "RESTARTING"):
                return
            self._count_death(cause)

    def _count_death(self, cause: str) -> None:
        """One death against ``max_restarts``, as the reference's controller
        counts it: restart while restarts remain, else the actor is DEAD and
        its lease goes back. Called with ``cond`` held."""
        restartable = (not self.no_restart and not self.runtime.stopping
                       and (self.max_restarts < 0 or self.restarts < self.max_restarts))
        if restartable:
            self.restarts += 1
            self.state = "RESTARTING"
            self.tasks.put(_RESTART)
        else:
            self.state, self.dead = "DEAD", cause
            self._release()
        self.cond.notify_all()

    def _release(self) -> None:
        lease, self.lease = self.lease, None
        if lease is not None:
            lease.release()

    # -- the process ---------------------------------------------------------
    def _lease(self) -> bool:
        """Takes the actor's lease, waiting while the host is full."""
        if self.lease is not None or not self.bundle:
            return True
        from ray_tpu_torch._private import resources

        while not self.runtime.stopping and self.state != "DEAD":
            try:
                lease = resources.ledger().acquire(self.bundle, 1, timeout=_WATCH_S)
            except resources.InfeasibleResourcesError as exc:
                self._set("DEAD", f"its resources can never be placed: {exc}")
                return False
            except resources.PlacementGroupUnschedulableError:
                continue
            with self.cond:
                if self.state == "DEAD":  # killed while it waited
                    lease.release()
                    return False
                self.lease = lease
                return True
        return False

    def _start(self) -> bool:
        """Leases, starts a process and waits for its first message."""
        if not self._lease():
            return False
        visible = self.lease.visible_devices() if self.bundle.get("GPU") else ""
        with self.cond:
            self.generation += 1
        self.proc, self.conn = _spawn(self.name, visible, actor=True)
        try:
            _, _, self.address = self.conn.recv()
        except (EOFError, OSError):
            self.address = None  # a process that died at its start fails its constructor
        return True

    def _send(self, message: bytes):
        self.runtime.count_message()
        self.conn.send_bytes(message)
        return self.conn.recv()

    def _restart(self) -> None:
        """A new process of the same class and constructor arguments."""
        if self.conn is not None:
            self.conn.close()
        if self.proc is not None and self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        if not self._start():
            return
        gen = self.generation
        try:
            reply = self._send(self.init_task.message)
        except (EOFError, OSError):
            # The new process died before its constructor answered: one more
            # death (the actor is RESTARTING, so not through _died).
            self.proc.join(1.0)
            with self.cond:
                if gen == self.generation and self.state == "RESTARTING":
                    self._count_death(f"the actor process {self.name} ended while restarting "
                                      f"(exit code {self.proc.exitcode})")
            return
        if reply[0] == "ok":
            self._set("ALIVE")
        else:
            self._set("DEAD", f"its constructor raised {reply[1]}")
            self._release()

    def _loop(self) -> None:
        """The only thread that writes to the actor process's pipe."""
        if not self._start():
            self._fail_queued()
            return
        while True:
            try:
                task = self.tasks.get(timeout=_WATCH_S)
            except queue.Empty:
                self.check()
                continue
            if task is _STOP:
                if self.conn is not None:
                    try:
                        self.conn.send_bytes(_STOP_MESSAGE)
                    except OSError:
                        pass  # the process is gone
                return
            if task is _RESTART:
                self._restart()
                continue
            if self.state == "DEAD" or self.runtime.stopping:
                self.runtime.fail(task, WorkerCrashedError(
                    task.name, self.dead or "the runtime shut down"))
                continue
            gen = self.generation
            try:
                reply = self._send(task.message)
            except (EOFError, OSError):
                self.proc.join(1.0)
                cause = f"its process {self.name} ended (exit code {self.proc.exitcode})"
                self.runtime.fail(task, WorkerCrashedError(task.name, cause))
                self._died(gen, f"the actor process {self.name} ended (exit code "
                                f"{self.proc.exitcode})")
                continue
            if reply[0] == "ok":
                if task is self.init_task:
                    self._set("ALIVE")
                self.runtime.complete(task, reply[1])
            else:
                if task is self.init_task:
                    self._set("DEAD", f"its constructor raised {reply[1]}")
                    self._release()
                self.runtime.fail(task, TaskError(task.name, reply[1], reply[2]))

    def _fail_queued(self) -> None:
        while True:
            task = self.tasks.get()
            if task is _STOP:
                return
            if task is not _RESTART:
                self.runtime.fail(task, WorkerCrashedError(
                    task.name, self.dead or "the runtime shut down"))

    def kill(self, no_restart: bool = True) -> None:
        """Ends the process. With ``no_restart=False`` the death is counted
        before this returns, so a wait that follows sees RESTARTING (then
        ALIVE), never the process that was killed."""
        with self.cond:
            self.no_restart = self.no_restart or no_restart
            proc, gen = self.proc, self.generation
            if no_restart:
                self.state, self.dead = "DEAD", f"the actor {self.name} was killed"
                self._release()
                self.cond.notify_all()
        if proc is not None:
            proc.kill()
            if not no_restart:
                proc.join(5.0)
                self._died(gen, f"the actor process {self.name} was killed (exit code "
                                f"{proc.exitcode})")

    def restart(self) -> dict:
        """``restart_actor``: a DEAD actor comes back under its id; any other
        state is already where the caller wants it."""
        with self.cond:
            if self.state == "DEAD" and self.init_task is not None:
                self.state, self.dead, self.no_restart = "RESTARTING", None, False
                self.tasks.put(_RESTART)
                self.cond.notify_all()
            return {"status": "ok", "state": self.state}

    def control(self, op: str, payload: dict, timeout: float = 60.0) -> dict:
        """One graph message to the actor process's socket."""
        address = self.address
        if address is None:
            raise WorkerCrashedError(op, f"the actor {self.name} has no graph socket "
                                         f"(state {self.state})")
        self.runtime.count_message()
        return _control_client(address).call(op, payload, timeout)

    def reap(self, deadline: float) -> None:
        """After a _STOP was queued for this actor's thread: waits for the
        process until ``deadline``, kills it if it is still running, and
        closes the pipe."""
        self.thread.join(max(0.0, deadline - time.monotonic()) + 1.0)
        if self.proc is not None:
            self.proc.join(max(0.0, deadline - time.monotonic()))
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
        self.thread.join(5.0)
        if self.conn is not None:
            self.conn.close()
        if self.address is not None:
            with _clients_lock:
                client = _clients.pop(self.address, None)
            if client is not None:
                client.close()
        with self.cond:
            self._release()


class _Runtime:
    """This process's pool, actors, dependency tracking and store. The pool
    starts with the first task."""

    def __init__(self, num_workers: int):
        self.store = _Store()
        self.num_workers = num_workers
        self.stopping = False
        self._cond = threading.Condition(threading.RLock())
        self._state: dict[str, str] = {}       # id -> "pending" | "ready" | "error"
        self._errors: dict[str, TaskError] = {}
        self._waiters: dict[str, list[_Task]] = collections.defaultdict(list)
        self._ids = itertools.count()
        self.pool_queue: queue.Queue = queue.Queue()
        self.pool: list[_Executor] = []
        self.pool_started = 0.0
        self.actors: list[_ActorExecutor] = []
        self.actor_table: dict[str, _ActorExecutor] = {}
        self.actor_messages = 0

    def start_pool(self) -> None:
        with self._cond:
            if self.pool or self.stopping:
                return
            self.pool_started = time.perf_counter()
            self.pool = [_Executor(self, f"data-worker-{i}", self.pool_queue)
                         for i in range(self.num_workers)]

    def pool_ready_s(self, timeout: float = 120.0) -> float:
        """Starts the pool if it has not started, waits until every worker
        process has started, and returns the seconds from the pool's start
        to the last worker's first message (spawn and imports)."""
        self.start_pool()
        for executor in self.pool:
            if not executor.ready.wait(timeout):
                raise TimeoutError(f"{executor.name} did not start within {timeout} s")
        return max(e.ready_at for e in self.pool) - self.pool_started

    # -- submission --------------------------------------------------------
    def submit(self, name: str, kind: str, fn: Any, args: tuple, kwargs: dict,
               num_returns: int, actor: _ActorExecutor | None = None) -> list[ObjectRef]:
        """Submits one task (to the pool, or to ``actor``) and returns its
        output refs; it is queued once its ref arguments are ready."""
        outs = [self.store.new_ref() for _ in range(num_returns)]
        try:
            message = pickle.dumps((kind, fn, args, kwargs, [r.path for r in outs]),
                                   protocol=5)
        except (pickle.PicklingError, AttributeError, TypeError) as exc:
            raise TypeError(f"cannot submit {name}: {_PICKLE_RULE} ({exc})") from exc
        deps = [a for a in itertools.chain(args, kwargs.values()) if isinstance(a, ObjectRef)]
        if actor is not None and actor.init_ref is not None:
            deps.append(actor.init_ref)
        if actor is None:
            self.start_pool()
        task = _Task(name, message, outs, deps)
        task.target = self.pool_queue if actor is None else actor.tasks
        if kind == "init":
            actor.init_task = task
        with self._cond:
            for ref in outs:
                self._state[ref.id] = "pending"
            if actor is not None and actor.dead is not None:
                self._fail_locked(task, WorkerCrashedError(name, actor.dead))
                return outs
            failed = next((self._errors[d.id] for d in deps
                           if self._state.get(d.id) == "error"), None)
            if failed is not None:
                self._fail_locked(task, failed)
                return outs
            for dep in deps:
                if self._state.get(dep.id) == "pending":
                    self._waiters[dep.id].append(task)
                    task.waiting += 1
            if task.waiting == 0:
                task.target.put(task)
        return outs

    def complete(self, task: _Task, sizes: list[int]) -> None:
        task.deps = []
        for ref, size in zip(task.outs, sizes):
            self.store.sealed(ref, size)
        with self._cond:
            for ref in task.outs:
                self._state[ref.id] = "ready"
                for waiter in self._waiters.pop(ref.id, ()):
                    waiter.waiting -= 1
                    if waiter.waiting == 0:
                        waiter.target.put(waiter)
            self._cond.notify_all()

    def fail(self, task: _Task, error: TaskError) -> None:
        with self._cond:
            self._fail_locked(task, error)

    def _fail_locked(self, task: _Task, error: TaskError) -> None:
        """Fails ``task``'s outputs and, through them, every task waiting
        on one of them."""
        task.waiting, task.deps = -1, []  # never queued from here on
        for ref in task.outs:
            try:
                _write_object(_err_path(ref.path), error)
            except OSError:
                pass  # the store is being removed
            self._state[ref.id] = "error"
            self._errors[ref.id] = error
            for waiter in self._waiters.pop(ref.id, ()):
                if waiter.waiting > 0:
                    self._fail_locked(waiter, error)
        self._cond.notify_all()

    # -- reading -----------------------------------------------------------
    def state(self, ref: ObjectRef) -> str | None:
        return self._state.get(ref.id)

    def wait_owned(self, refs: list[ObjectRef], num: int, deadline: float | None) -> None:
        with self._cond:
            while sum(self._state.get(r.id) != "pending" for r in refs) < num:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return
                self._cond.wait(left)

    def start_actor(self, cls: "ActorClass", args: tuple, kwargs: dict,
                    options: dict | None = None) -> "ActorHandle":
        """Starts an actor: leases what ``options`` ask from this host's
        ledger (raising at once when the host can never hold it) and runs
        the constructor in a process of its own."""
        from ray_tpu_torch._private import resources

        options = options or {}
        bundle = {"CPU": float(options.get("num_cpus") or 0),
                  "GPU": float(options.get("num_gpus") or 0),
                  **{k: float(v) for k, v in (options.get("resources") or {}).items()}}
        bundle = {k: v for k, v in bundle.items() if v}
        lease = None
        if bundle:
            try:
                lease = resources.ledger().acquire(bundle, 1, timeout=0.0)
            except resources.InfeasibleResourcesError:
                raise
            except resources.PlacementGroupUnschedulableError:
                lease = None  # waits in the actor's thread, the actor PENDING
        name = _qualname(cls)
        actor_id = uuid.uuid4().hex[:16]
        actor = _ActorExecutor(self, f"data-actor-{next(self._ids)}-{name}", actor_id,
                               bundle, lease, options.get("max_restarts") or 0)
        with self._cond:
            self.actors.append(actor)
            self.actor_table[actor_id] = actor
        init = self.submit(f"{name}.__init__", "init", cls, args, kwargs, 1, actor)[0]
        actor.init_ref = init
        return ActorHandle(actor, name)

    def kill(self, actor: _ActorExecutor, no_restart: bool = True) -> None:
        actor.kill(no_restart)

    def actor(self, actor_id: str) -> _ActorExecutor:
        with self._cond:
            actor = self.actor_table.get(actor_id)
        if actor is None:
            raise KeyError(f"no actor {actor_id} in this process")
        return actor

    def count_message(self) -> None:
        with self._cond:
            self.actor_messages += 1

    def shutdown(self, grace_s: float = 2.0) -> None:
        """Fails what is queued, stops every process (killing one whose task
        has not ended after ``grace_s``) and removes the store."""
        with self._cond:
            self.stopping = True
            executors = self.pool + self.actors
        for executor in executors:
            executor.tasks.put(_STOP)  # one each: the pool's share a queue
        deadline = time.monotonic() + grace_s
        for executor in executors:
            executor.reap(deadline)
        self.store.remove()


def _qualname(obj: Any) -> str:
    obj = getattr(obj, "_cls", None) or getattr(obj, "_fn", obj)
    return getattr(obj, "__qualname__", type(obj).__name__)


_runtime: _Runtime | None = None
_runtime_lock = threading.Lock()


def init(num_workers: int | None = None) -> _Runtime:
    """Makes this process's store under the temporary directory and readies
    a pool of ``num_workers`` (when None, this process's CPUs up to 8),
    started by the first task; or returns the running one."""
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            _runtime = _Runtime(num_workers or min(8, len(os.sched_getaffinity(0))))
            atexit.register(shutdown)
        return _runtime


def runtime() -> _Runtime:
    return _runtime if _runtime is not None else init()


def shutdown() -> None:
    """Tears down every live compiled graph, stops the pool and every actor
    and removes the store's directory."""
    global _runtime
    dag = sys.modules.get("ray_tpu_torch.dag.dag")
    if dag is not None:
        dag.shutdown_all()
    with _runtime_lock:
        rt, _runtime = _runtime, None
    if rt is not None:
        rt.shutdown()


# ------------------------------------------------------------------ API
class RemoteFunction:
    """``fn.remote(*args)`` submits fn as a task; ``options(num_returns=)``."""

    def __init__(self, fn, num_returns: int = 1):
        self._fn, self._num_returns = fn, int(num_returns)

    def options(self, *, num_returns: int | None = None) -> "RemoteFunction":
        return RemoteFunction(self._fn, self._num_returns if num_returns is None
                              else num_returns)

    def remote(self, *args, **kwargs):
        refs = runtime().submit(_qualname(self._fn), "task", self, args, kwargs,
                                self._num_returns)
        return refs[0] if self._num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def __reduce__(self):
        # A module-level ``@remote`` function is the module's attribute: it
        # goes by name, and the worker runs the function it wraps.
        module = sys.modules.get(getattr(self._fn, "__module__", ""), None)
        named = getattr(module, getattr(self._fn, "__qualname__", ""), None)
        if isinstance(named, RemoteFunction) and named._fn is self._fn:
            return (_by_name, (self._fn.__module__, self._fn.__qualname__))
        return (RemoteFunction, (self._fn, self._num_returns))


class ActorClass:
    """``cls.remote(*args)`` starts an actor process holding ``cls(*args)``;
    ``cls.options(num_cpus=, num_gpus=, resources=, max_restarts=)`` a copy
    that leases those resources and restarts so often (module docstring)."""

    _OPTIONS = ("num_cpus", "num_gpus", "resources", "max_restarts")

    def __init__(self, cls, options: dict | None = None):
        self._cls, self._options = cls, dict(options or {})

    def options(self, **options) -> "ActorClass":
        unknown = sorted(set(options) - set(self._OPTIONS))
        if unknown:
            raise ValueError(f"unknown actor options {unknown} (known: {list(self._OPTIONS)})")
        return ActorClass(self._cls, {**self._options, **options})

    def remote(self, *args, **kwargs) -> "ActorHandle":
        return runtime().start_actor(self, args, kwargs, self._options)

    def __call__(self, *args, **kwargs):
        return self._cls(*args, **kwargs)

    def __reduce__(self):
        module = sys.modules.get(self._cls.__module__)
        if module is not None and getattr(module, self._cls.__qualname__, None) is self:
            return (_by_name, (self._cls.__module__, self._cls.__qualname__))
        return (ActorClass, (self._cls,))


def _by_name(module: str, qualname: str):
    import importlib

    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


class _ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle, self._name = handle, name

    def remote(self, *args, **kwargs) -> ObjectRef:
        h = self._handle
        return runtime().submit(f"{h._name}.{self._name}", "call", self._name, args, kwargs,
                                1, h._executor)[0]

    def bind(self, *args):
        """A compiled graph's node that calls this method (``ray_tpu_torch.dag``)."""
        from ray_tpu_torch.dag.dag import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args)


class ActorHandle:
    """A running actor: ``handle.method.remote(*args)``; ``_actor_id`` names
    it to ``actor_info`` and ``restart_actor``."""

    def __init__(self, executor: _ActorExecutor, name: str):
        self._executor, self._name = executor, name
        self._actor_id = executor.actor_id

    def __getattr__(self, name: str) -> _ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._name}, {self._actor_id})"


def remote(*args, num_returns: int = 1):
    """``@remote``, ``@remote(num_returns=n)``, or ``remote(fn)``."""
    def wrap(obj):
        return ActorClass(obj) if isinstance(obj, type) else RemoteFunction(obj, num_returns)

    if len(args) == 1 and callable(args[0]):
        return wrap(args[0])
    return wrap


def put(value: Any) -> ObjectRef:
    """Writes ``value`` to this process's store."""
    store = runtime().store
    ref = store.new_ref()
    store.sealed(ref, _write_object(ref.path, value))
    return ref


def _get_one(ref: ObjectRef, deadline: float | None) -> Any:
    if not isinstance(ref, ObjectRef):
        # The runtime's refs (ray_tpu_torch.put, .remote) are another type
        # until this layer moves onto the runtime (ROADMAP item 14b-ii-b).
        raise TypeError(
            f"local_tasks.get takes this layer's ObjectRefs, not {type(ref).__module__}."
            f"{type(ref).__name__}: the two runtimes meet in ROADMAP Queue A item 14b-ii-b")
    rt = _runtime
    if rt is not None and rt.state(ref) == "pending":
        rt.wait_owned([ref], 1, deadline)
    delay = 0.0005
    while True:
        try:
            return _read_object(ref.path)
        except FileNotFoundError:
            pass
        try:
            error = _read_object(_err_path(ref.path))
        except FileNotFoundError:
            error = None
        if error is not None:
            raise error
        if deadline is not None and time.monotonic() >= deadline:
            raise GetTimeoutError(f"{ref} was not ready in time")
        time.sleep(delay)
        delay = min(0.05, delay * 2)


def get(refs, *, timeout: float | None = None):
    """The value of a ref, or the values of a list of refs."""
    deadline = None if timeout is None else time.monotonic() + timeout
    if isinstance(refs, ObjectRef) or not isinstance(refs, (list, tuple)):
        return _get_one(refs, deadline)
    return [_get_one(r, deadline) for r in refs]


def _is_ready(ref: ObjectRef) -> bool:
    rt = _runtime
    state = rt.state(ref) if rt is not None else None
    if state is not None:
        return state != "pending"
    return os.path.exists(ref.path) or os.path.exists(_err_path(ref.path))


def wait(refs: Iterable[ObjectRef], *, num_returns: int = 1,
         timeout: float | None = None) -> tuple[list, list]:
    """(ready, not ready), each in the order given, with at most
    ``num_returns`` ready once that many are or ``timeout`` passed."""
    refs = list(refs)
    num_returns = min(num_returns, len(refs))
    deadline = None if timeout is None else time.monotonic() + timeout
    rt = _runtime
    delay = 0.0005
    while True:
        ready = [r for r in refs if _is_ready(r)]
        if len(ready) >= num_returns or (deadline is not None
                                         and time.monotonic() >= deadline):
            break
        owned = rt is not None and all(rt.state(r) is not None for r in refs)
        if owned:
            rt.wait_owned(refs, num_returns, deadline)
        else:
            time.sleep(delay)
            delay = min(0.05, delay * 2)
    ready = ready[:num_returns]
    taken = {r.id for r in ready}
    return ready, [r for r in refs if r.id not in taken]


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    """Ends the actor's process; its pending and later calls fail. With
    ``no_restart=False`` the death counts against ``max_restarts`` as any
    other would."""
    runtime().kill(actor._executor, no_restart)


def actor_info(actor_id: str, wait_ready: bool = False, timeout: float = 60.0) -> dict:
    """The controller's ``get_actor_info`` for a local actor: its state
    (PENDING, ALIVE, RESTARTING or DEAD), pid, graph socket, death cause
    and restarts; with ``wait_ready``, once it is ALIVE or DEAD (at most
    ``timeout`` s)."""
    actor = runtime().actor(actor_id)
    return actor.wait_ready(timeout) if wait_ready else actor.info()


def restart_actor(actor_id: str) -> dict:
    """The controller's ``restart_actor``: a DEAD actor gets a new process
    from its class and constructor arguments, under the same id (poll
    ``actor_info`` for ALIVE); any other state is left as it is."""
    return runtime().actor(actor_id).restart()


def actor_control(actor_id: str, op: str, payload: dict, timeout: float = 60.0) -> dict:
    """One graph message (``dag_register``, ``dag_push``, ...) to an actor."""
    return runtime().actor(actor_id).control(op, payload, timeout)


def actor_messages() -> int:
    """The messages this process has sent to actors so far: calls (the
    constructor's too) and graph messages."""
    return runtime().actor_messages


def store_stats() -> dict:
    """This process's store: bytes used and capacity (the free bytes of its
    filesystem when it started)."""
    return runtime().store.stats()
