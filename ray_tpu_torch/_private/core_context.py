"""CoreContext — the in-process runtime of every driver and worker.

Role-equivalent of the reference's C++ core worker
(src/ray/core_worker/core_worker.cc :: CoreWorker [N18]) plus its satellite
managers: task submission (transport/normal_task_submitter.cc,
actor_task_submitter.cc [N19]), reference counting (reference_count.cc [N21]),
task retries + lineage (task_manager.cc [N22]), object recovery
(object_recovery_manager.cc [N23]), in-process memory store
(memory_store.cc [N24]) and the plasma provider [N25].

Sync public API over an asyncio core running on the IoThread.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextlib
import os
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Sequence

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import serialization, wire_gen
from ray_tpu_torch._private.config import global_config
from ray_tpu_torch.util import tracing
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import ObjectStoreClient, ObjectStoreFull
from ray_tpu_torch._private.rpc import (
    ConnectionLost, ERR, IoThread, REP, RpcClient, RpcError, RpcServer,
    native_available, spawn_task,
)

PENDING, INLINE, SHM, FAILED = "pending", "inline", "shm", "failed"

# Sentinel: the direct-lane get() could not prove everything local and the
# caller must fall back to the asyncio path.
_DIRECT_MISS = object()

# Zero-copy reads: values whose out-of-band buffers exceed this stay views
# onto the arena (object pinned until the value is GC'd); smaller values are
# copied out and released immediately.
_ZERO_COPY_THRESHOLD = 1 << 20


class ObjectState:
    __slots__ = (
        "status", "data", "locations", "size", "error", "event", "record",
        "waited",
    )

    def __init__(self):
        self.status = PENDING
        self.data: bytes | None = None
        self.locations: list[dict] = []
        self.size = 0
        self.error: str | None = None
        self.event = asyncio.Event()
        # Direct-lane backlink: the PendingTask whose native reply settles
        # this state (None for put()s and asyncio-path tasks).
        self.record: "PendingTask | None" = None
        # True once a loop-side waiter parked on `event`; caller-thread
        # settles then notify the loop (asyncio.Event is not thread-safe
        # to set from outside, and an unconditional call_soon_threadsafe
        # per task would cost a loop wakeup per task).
        self.waited = False


class LeasedWorker:
    __slots__ = ("worker_id", "address", "client", "lease_id", "agent_addr", "resources_key")

    def __init__(self, worker_id, address, client, lease_id, agent_addr, resources_key):
        self.worker_id = worker_id
        self.address = address
        self.client = client
        self.lease_id = lease_id
        self.agent_addr = agent_addr
        self.resources_key = resources_key


class PendingTask:
    __slots__ = (
        "spec", "attempts", "return_ids", "arg_refs", "done",
        "direct", "native_handle", "direct_worker", "settle_lock",
        "done_event", "queue_key",
    )

    def __init__(self, spec, return_ids, arg_refs):
        self.spec = spec
        self.attempts = 0
        self.return_ids = return_ids
        self.arg_refs = arg_refs
        self.done = False
        self.queue_key = None  # precomputed dispatcher-queue key
        # Direct-lane fields (set by the native submitter): the in-flight
        # C++ call handle, the pool worker it rode, and settle coordination
        # (first settler consumes the handle; others wait on done_event,
        # which is a threading.Event — safe to set from any thread).
        self.direct = False
        self.native_handle: int | None = None
        self.direct_worker: "DirectWorker | None" = None
        self.settle_lock: threading.Lock | None = None
        self.done_event: threading.Event | None = None

    def make_direct(self) -> None:
        self.direct = True
        self.settle_lock = threading.Lock()
        self.done_event = threading.Event()


class DirectWorker:
    """A leased worker conn owned by the direct-call lane (the lease-reuse
    role of a dispatcher, minus the asyncio machinery)."""

    __slots__ = ("leased", "conn_id", "inflight", "last_used", "dead")

    def __init__(self, leased: "LeasedWorker", conn_id: int):
        self.leased = leased
        self.conn_id = conn_id
        self.inflight = 0
        self.last_used = time.monotonic()
        self.dead = False


def _resources_key(resources: dict, runtime_env_hash: str) -> str:
    # A leased worker sees its lease's cards (CUDA_VISIBLE_DEVICES, fixed by
    # the node agent at spawn), and a key reuses only its own leases: tasks
    # of one GPU shape share that shape's leases, never another key's.
    return repr(sorted(resources.items())) + "|" + runtime_env_hash


class CoreContext:
    def __init__(
        self,
        *,
        job_id: str,
        node_id: str,
        controller_addr: tuple,
        agent_addr: tuple,
        store_info: dict,
        is_driver: bool,
        worker_id: str | None = None,
    ):
        self.job_id = JobID(job_id)
        self.node_id = NodeID(node_id)
        self.worker_id = WorkerID(worker_id) if worker_id else WorkerID.random()
        self.is_driver = is_driver
        self.io = IoThread()
        self.controller_addr = tuple(controller_addr)
        self.agent_addr = tuple(agent_addr)
        self.store_info = store_info  # {socket, shm_path, capacity, spill_dir}
        self._store: ObjectStoreClient | None = None
        self._store_lock = threading.Lock()

        # owner-side object state (memory store + object directory)
        self._objects: dict[str, ObjectState] = {}
        # distributed refcounting
        self._local_refs: dict[str, int] = {}
        self._submitted_refs: dict[str, int] = {}
        self._borrowers: dict[str, set[str]] = {}
        self._borrowed: dict[str, tuple] = {}  # obj_id -> owner_addr we registered with
        self._refs_lock = threading.Lock()
        # lineage: obj_id -> PendingTask of creating task (kept while refs live)
        self._lineage: dict[str, PendingTask] = {}
        self._task_counter = 0
        self._put_counter = 0
        self._counter_lock = threading.Lock()

        # cancellation (reference: CoreWorker::CancelTask [N18] +
        # task_manager.cc cancelled-task bookkeeping)
        self._cancelled_tasks: set[str] = set()
        self._running_tasks: dict[str, RpcClient] = {}  # task_id -> worker client
        self._task_records: dict[str, PendingTask] = {}

        # Direct-call lane (native C++ call table, [N19] direct calls):
        # caller threads submit/settle without touching the asyncio loop.
        self._engine = None  # _NativeEngine of the io loop (set on connect)
        self._fastlane = None  # _fastlane C extension (set on connect)
        self._actor_spec_parts: dict[tuple, tuple] = {}
        self._direct_lock = threading.Lock()
        self._direct_pool: dict[str, list[DirectWorker]] = {}
        self._direct_grows: dict[str, int] = {}
        self._direct_backoff: dict[str, float] = {}
        self._direct_reaper_started = False
        self._actor_pending_slow: dict[str, int] = {}
        self._actor_spec_templates: dict[tuple, dict] = {}
        # Unsettled direct calls (GIL-guarded int): >=2 means a burst is in
        # flight, so submits use the buffered send (engine-thread writev)
        # instead of paying an inline syscall + preemption per frame.
        self._direct_unsettled = 0

        # lease cache: resources_key -> list[LeasedWorker]
        self._idle_leases: dict[str, list[LeasedWorker]] = {}
        self._task_queues: dict[str, asyncio.Queue] = {}
        self._active_dispatchers: dict[str, int] = {}
        self._submit_buf: collections.deque = collections.deque()
        self._submit_lock = threading.Lock()
        self._submit_scheduled = False
        self._lease_capacity_hint: dict[str, int] = {}
        self._enqueue_counter = 0
        # direct clients: address -> RpcClient
        self._clients: dict[tuple, RpcClient] = {}
        self._client_dials: dict[tuple, asyncio.Task] = {}
        # actor bookkeeping
        self._actor_addr_cache: dict[str, tuple] = {}
        self._actor_seq: dict[str, int] = {}
        self._actor_seq_lock = threading.Lock()
        # Per-actor in-order send gates (io-loop state): actor push frames
        # must hit the wire in seq order even when earlier submissions are
        # still resolving the actor's address (reference
        # actor_task_submitter.cc sends in order, replies pipeline freely).
        self._actor_send_gate: dict[str, dict] = {}

        self.controller: RpcClient | None = None
        self._subscribed_channels: set[str] = set()
        self.agent: RpcClient | None = None
        self.core_server = RpcServer(name=f"core-{self.worker_id[:12]}")
        self.address: tuple | None = None

        # function table cache (worker side)
        self._function_cache: dict[str, Any] = {}
        # Slim lifecycle-event tuples buffered by the worker runtime:
        # (task_id, name, state, start_ts, ts, resources|None) — expanded
        # into full records at flush (worker_proc._record_task_event).
        self._task_events: list[tuple] = []
        self._shutdown = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def connect(self) -> None:
        self.io.run(self._connect_async())

    async def _connect_async(self) -> None:
        self.core_server.route_object(self)
        port = await self.core_server.start()
        self.address = ("127.0.0.1", port)
        if native_available() and global_config().direct_call:
            from ray_tpu_torch import _native
            from ray_tpu_torch._private.rpc import _NativeEngine

            self._engine = _NativeEngine.for_running_loop()
            self._fastlane = _native.load_fastlane()
        self.controller = RpcClient(
            self.controller_addr, name="to-controller", auto_reconnect=True
        )
        self.controller.chaos_peer = "controller"
        await self.controller.connect()
        self.agent = RpcClient(self.agent_addr, name="to-agent")
        self.agent.chaos_peer = f"node:{self.node_id}"
        await self.agent.connect()
        # Replayed after a controller restart (gcs_client reconnect role).
        self.controller.on_reconnect = self._controller_handshake
        await self._controller_handshake()

    async def _controller_handshake(self) -> None:
        await self.controller.call(
            "register_client",
            {
                "worker_id": self.worker_id,
                "job_id": self.job_id,
                "node_id": self.node_id,
                "address": list(self.address),
                "is_driver": self.is_driver,
            },
        )
        if self._subscribed_channels:
            await self.controller.call(
                "subscribe", {"channels": sorted(self._subscribed_channels)}
            )

    async def subscribe_channels(self, channels: list[str]) -> None:
        """Subscribe to controller pubsub channels; re-subscribed
        automatically after a controller restart."""
        self._subscribed_channels.update(channels)
        await self.controller.call("subscribe", {"channels": channels})

    @property
    def store(self) -> ObjectStoreClient:
        if self._store is None:
            with self._store_lock:
                if self._store is None:
                    self._store = ObjectStoreClient(
                        self.store_info["socket"],
                        self.store_info["shm_path"],
                        self.store_info["capacity"],
                    )
        return self._store

    def shutdown(self) -> None:
        self._shutdown = True
        try:
            self.io.run(self._shutdown_async(), timeout=5)
        except Exception:  # rtlint: disable=swallowed-exception - shutdown must not raise; io loop may already be gone
            pass
        self.io.stop()

    async def _shutdown_async(self) -> None:
        # Final task-event flush (companion to util/metrics' atexit
        # flush): a short-lived worker exiting under the size/time batch
        # thresholds must not drop the tail of its lifecycle + resource-
        # attribution stream.
        if self._task_events and self.controller is not None:
            slim, self._task_events = self._task_events, []
            events = []
            for task_id, name, state, start_ts, ts, extras in slim:
                event = {
                    "task_id": task_id,
                    "name": name,
                    "state": state,
                    "node_id": self.node_id,
                    "worker_id": self.worker_id,
                    "pid": os.getpid(),
                    "ts": ts,
                }
                if start_ts is not None:
                    event["start_ts"] = start_ts
                if extras:
                    event.update(extras)
                events.append(event)
            try:
                await self.controller.call(
                    "report_task_events", {"events": events}, timeout=2
                )
            except Exception:  # rtlint: disable=swallowed-exception - final task-event flush is advisory at shutdown
                pass
        for addr, owner in list(self._borrowed.items()):
            try:
                client = await self._client_for(tuple(owner))
                await client.call("remove_borrower", {"object_id": addr, "borrower": self.worker_id}, timeout=1)
            except Exception:  # rtlint: disable=swallowed-exception - owner may be gone at shutdown; borrow GC is advisory
                pass
        if self.controller is not None:
            await self.controller.close()
        if self.agent is not None:
            await self.agent.close()
        # Close every outstanding peer client (direct, actor, leased-worker)
        # so their recv loops are reaped — dropping them unclosed leaves
        # "Task was destroyed but it is pending!" noise at exit.
        with self._direct_lock:
            direct_workers = [
                dw for pool in self._direct_pool.values() for dw in pool
            ]
            self._direct_pool.clear()
        for dw in direct_workers:
            try:
                await self._release_lease(dw.leased, reusable=True)
            except Exception:  # rtlint: disable=swallowed-exception - lease release at shutdown; agent may be gone
                pass
        peers = list(self._clients.values())
        for leases in self._idle_leases.values():
            peers.extend(w.client for w in leases if w.client is not None)
        for client in peers:
            try:
                await client.close()
            except Exception:  # rtlint: disable=swallowed-exception - peer close at shutdown
                pass
        self._clients.clear()
        self._idle_leases.clear()
        await self.core_server.stop()

    async def _client_for(self, address: tuple) -> RpcClient:
        address = tuple(address)
        client = self._clients.get(address)
        if client is not None and client.connected:
            return client
        # Single-flight dial per address: a burst of concurrent calls shares
        # ONE connect attempt (and its retry backoff) instead of each dialing
        # its own connection — duplicate dials leaked unclosed recv loops,
        # and per-waiter sequential re-dials to a dead peer would serialize
        # N full backoff windows.
        dial = self._client_dials.get(address)
        if dial is None:
            dial = asyncio.get_running_loop().create_task(self._dial(address))
            self._client_dials[address] = dial
            dial.add_done_callback(
                lambda _t, a=address: self._client_dials.pop(a, None)
            )
        # shield: one waiter's cancellation must not abort the shared dial.
        return await asyncio.shield(dial)

    async def _dial(self, address: tuple) -> RpcClient:
        stale = self._clients.get(address)
        client = RpcClient(address, name=f"to-{address}")
        await client.connect()
        self._clients[address] = client
        if stale is not None:
            try:
                await stale.close()
            except Exception:  # rtlint: disable=swallowed-exception - closing a stale superseded connection
                pass
        return client

    # ------------------------------------------------------------------
    # reference counting (N21)
    # ------------------------------------------------------------------
    def add_local_ref(self, object_id: str) -> None:
        with self._refs_lock:
            self._local_refs[object_id] = self._local_refs.get(object_id, 0) + 1

    def remove_local_ref(self, object_id: str) -> None:
        if self._shutdown:
            return
        with self._refs_lock:
            count = self._local_refs.get(object_id, 0) - 1
            if count <= 0:
                self._local_refs.pop(object_id, None)
            else:
                self._local_refs[object_id] = count
                return
        self._maybe_free(object_id)

    def _maybe_free(self, object_id: str) -> None:
        with self._refs_lock:
            if (
                self._local_refs.get(object_id, 0) > 0
                or self._submitted_refs.get(object_id, 0) > 0
                or self._borrowers.get(object_id)
            ):
                return
            owned = object_id in self._objects
        if not owned:
            # We were a borrower: tell the owner we're done.
            owner = self._borrowed.pop(object_id, None)
            if owner is not None:
                self.io.spawn(self._notify_remove_borrower(object_id, owner))
            return
        # Free synchronously on THIS thread: for inline objects (the per-task
        # common case) the whole release is dict pops + an optional native
        # abandon — paying a run_coroutine_threadsafe loop wakeup (~50us on
        # 1-core hosts) per dropped ref would dominate small-task throughput.
        # Only SHM deletion needs the io loop (it's an RPC).
        state = self._objects.pop(object_id, None)
        self._lineage.pop(object_id, None)
        if state is None:
            return
        record = state.record
        if (
            record is not None
            and record.direct
            and not record.done
            and all(rid not in self._objects for rid in record.return_ids)
        ):
            # Fire-and-forget: every ref to this direct-lane task's returns
            # is gone and nobody will ever collect the reply — abandon the
            # native call entry (the task still executes; only the reply
            # is dropped, matching ignored-ref semantics) so the C++ call
            # table, task records, and worker inflight counts don't leak.
            self._direct_abandon(record)
        if state.status != SHM:
            return
        self.io.spawn(self._delete_shm_object(object_id, list(state.locations)))

    async def _notify_remove_borrower(self, object_id: str, owner: tuple) -> None:
        try:
            client = await self._client_for(owner)
            await client.call(
                "remove_borrower", {"object_id": object_id, "borrower": self.worker_id}
            )
        except Exception:  # rtlint: disable=swallowed-exception - owner death invalidates the borrow anyway
            pass

    async def _delete_shm_object(self, object_id: str, locations: list) -> None:
        for loc in locations:
            try:
                client = await self._client_for((loc["agent_host"], loc["agent_port"]))
                await client.call("delete_object", {"object_id": object_id})
            except Exception:  # rtlint: disable=swallowed-exception - delete fan-out; a dead agent holds no object
                pass

    # ------------------------------------------------------------------
    # put / get / wait
    # ------------------------------------------------------------------
    def new_object_ref(self, object_id: str) -> ObjectRef:
        return ObjectRef(object_id, self.address, runtime=self)

    def put(self, value: Any) -> ObjectRef:
        with self._counter_lock:
            self._put_counter += 1
            put_index = self._put_counter
        task_scope = TaskID(f"tsk-{self.worker_id}")
        object_id = ObjectID.for_put(task_scope, put_index)
        parts, total, contained = serialization.serialize_parts(value)
        self._register_contained_borrows(contained)
        state = ObjectState()
        cfg = global_config()
        if total <= cfg.max_direct_call_object_size:
            state.status = INLINE
            state.data = b"".join(
                bytes(p) if isinstance(p, memoryview) else p for p in parts
            )
            state.size = total
        else:
            self._store_put_parts(object_id, parts, total)
            state.status = SHM
            state.size = total
            state.locations = [self._local_location()]
        # Publish directly from this thread: the state is settled before
        # anyone can see it, so setting the (waiterless) event is safe and
        # the put pays no io-loop round-trip.
        state.event.set()
        self._objects[object_id] = state
        return self.new_object_ref(object_id)

    def _store_put_local(self, object_id: str, payload: bytes) -> None:
        try:
            self.store.put(object_id, payload)
            self.store.pin(object_id)
        except FileExistsError:
            pass
        except ObjectStoreFull as exc:
            raise exceptions.ObjectStoreFullError(str(exc)) from None

    def _store_put_parts(self, object_id: str, parts: list, total: int) -> None:
        """Scatter-gather write: stream serialized parts straight into the
        arena allocation (single copy; plasma create/seal discipline)."""
        try:
            view = self.store.create(object_id, total)
            offset = 0
            for part in parts:
                n = part.nbytes if isinstance(part, memoryview) else len(part)
                view[offset : offset + n] = part
                offset += n
            self.store.seal(object_id)
            self.store.pin(object_id)
        except FileExistsError:
            pass
        except ObjectStoreFull as exc:
            raise exceptions.ObjectStoreFullError(str(exc)) from None

    def _local_location(self) -> dict:
        return {
            "node_id": self.node_id,
            "socket": self.store_info["socket"],
            "shm_path": self.store_info["shm_path"],
            "capacity": self.store_info["capacity"],
            "agent_host": self.agent_addr[0],
            "agent_port": self.agent_addr[1],
        }

    def _register_contained_borrows(self, refs: Sequence[ObjectRef]) -> None:
        """Objects nested inside a stored value: keep them alive while the
        outer value exists (simplified nested-ref handling of [N21])."""
        for ref in refs:
            self.add_local_ref(ref.id)  # leak-safe: freed at shutdown

    def get(self, refs: ObjectRef | Sequence[ObjectRef], timeout: float | None = None) -> Any:
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        if self._engine is not None and ref_list:
            values = self._get_direct(ref_list, timeout)
            if values is not _DIRECT_MISS:
                return values[0] if single else values

        async def _gather():
            return await asyncio.wait_for(
                asyncio.gather(*(self._get_one(r) for r in ref_list)), timeout
            )

        try:
            values = self.io.run(_gather())
        except (asyncio.TimeoutError, concurrent.futures.TimeoutError):
            if os.environ.get("RAY_TPU_debug_hang"):
                self._dump_hang_state([r.id for r in ref_list])
            raise exceptions.GetTimeoutError(
                f"get() timed out after {timeout}s"
            ) from None
        return values[0] if single else values

    @staticmethod
    def _conn_debug(client) -> tuple | str:
        """Native-engine wq state of a client's conn (hang forensics)."""
        import ctypes

        engine = getattr(client, "_engine", None)
        conn = getattr(client, "_conn_id", None)
        if engine is None or conn is None:
            return "no-native-conn"
        out = (ctypes.c_longlong * 6)()
        rc = engine.lib.rt_conn_debug(engine.handle, conn, out)
        if rc != 0:
            return "conn-unknown-to-engine"
        return {
            "wq_len": out[0], "woff": out[1], "fd": out[2],
            "closed": out[3], "bytes_queued": out[4],
            "unparsed_rbuf": out[5], "conn_id": conn,
        }

    def _dump_hang_state(self, waiting_ids: list) -> None:
        """RAY_TPU_debug_hang=1: print submitter state when a get times
        out — first tool to reach for on a silent stall. Also appended to
        <tempdir>/raytpu_torch_hang.log (pytest captures stderr of a test that never
        finishes, which is exactly when this fires)."""
        import sys

        lines = [
            "=== blocked get/wait: submitter state ===",
            f"waiting on: {waiting_ids}",
            "records: "
            + repr(
                {
                    k: (v.done, v.attempts, v.spec.get("name"))
                    for k, v in self._task_records.items()
                }
            ),
            "dispatchers: " + repr(dict(self._active_dispatchers)),
            "hints: " + repr(dict(self._lease_capacity_hint)),
            "queues: "
            + repr({k: q.qsize() for k, q in self._task_queues.items()}),
            "running: "
            + repr(
                {
                    t: (
                        getattr(c, "address", "?"),
                        getattr(c, "connected", "?"),
                        self._conn_debug(c),
                    )
                    for t, c in self._running_tasks.items()
                }
            ),
            "waiting states: "
            + repr(
                {
                    i: getattr(self._objects.get(i), "status", "?")
                    for i in waiting_ids
                }
            ),
        ]
        text = "\n".join(lines)
        print(text, file=sys.stderr)
        try:
            import tempfile

            with open(os.path.join(tempfile.gettempdir(), "raytpu_torch_hang.log"), "a") as fh:
                fh.write(text + "\n\n")
        except OSError:
            pass

    def as_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(self._get_one(ref), self.io.loop)

    async def get_on_loop(self, ref: ObjectRef, executor) -> Any:
        """``ref``'s value, awaited on the caller's own event loop: a direct
        lane call settles on a thread of ``executor`` (the engine's wait
        blocks it) and an inline reply or an error is read here, with no
        hop through this context's io loop; anything else (the store, a
        ref this process does not own) goes through ``as_future``."""
        state = self._objects.get(ref.id)
        record = state.record if state is not None else None
        if record is not None and record.direct and not record.done:
            settle = asyncio.get_running_loop().run_in_executor(
                executor, self._settle_native, record, None)
            # A caller cancelled here (a hedge's loser) leaves the settle
            # running until the reply or the connection's loss. The ref
            # rides the settle, so it drops after it: dropped now, its last
            # ref would make ``_direct_abandon`` wait on this loop for the
            # settle's lock.
            settle.add_done_callback(lambda _settled, _ref=ref: None)
            await asyncio.shield(settle)
        if state is not None and state.status in (INLINE, FAILED):
            payload, pinned = await self._payload_from_state(ref.id, state)
            return self._deserialize_value(ref.id, payload, pinned)
        return await asyncio.wrap_future(self.as_future(ref))

    async def _get_one(self, ref: ObjectRef) -> Any:
        payload, pinned = await self._resolve_payload(ref)
        return self._deserialize_value(ref.id, payload, pinned)

    async def _resolve_payload(self, ref: ObjectRef) -> tuple[Any, bool]:
        """Returns (payload bytes/memoryview, is_pinned_view)."""
        state = self._objects.get(ref.id)
        if state is not None:
            await self._await_state(state)
            return await self._payload_from_state(ref.id, state)
        # Not the owner: ask the owner (blocks server-side until ready).
        owner = ref.owner_address
        if owner is None:
            raise exceptions.ObjectLostError(f"{ref.id}: no owner address")
        client = await self._client_for(owner)
        try:
            resp = await client.call("get_object", {"object_id": ref.id})
        except (ConnectionLost, RpcError) as exc:
            raise exceptions.ObjectLostError(
                f"{ref.id}: owner {owner} unreachable ({exc})"
            ) from None
        if resp["status"] == "failed":
            self._raise_stored_error(resp["error"])
        if resp["status"] == "inline":
            return resp["data"], False
        # shm
        data = await self._fetch_shm(ref.id, resp["locations"], resp["size"])
        return data, True

    async def _payload_from_state(self, object_id: str, state: ObjectState):
        if state.status == FAILED:
            self._raise_stored_error(state.error)
        if state.status == INLINE:
            return state.data, False
        data = await self._fetch_shm(object_id, state.locations, state.size)
        return data, True

    def _raise_stored_error(self, error_payload) -> None:
        exc = serialization.deserialize(error_payload)
        raise exc

    async def _fetch_shm(self, object_id: str, locations: list[dict], size: int):
        """Local store first; else pull via the remote node's agent
        (object_manager.cc / pull_manager.cc-equivalent path [N16])."""
        view = self.store.get(object_id, timeout_ms=0)
        if view is not None:
            return view
        for loc in locations:
            if loc["node_id"] == self.node_id:
                view = self.store.get(object_id, timeout_ms=2000)
                if view is not None:
                    return view
                continue
            try:
                if tracing.enabled():
                    with tracing.span(
                        "object_pull", object_id=object_id,
                        src_node=loc["node_id"],
                    ) as pspan:
                        data = await self._pull_remote(object_id, loc)
                        if pspan is not None and data is not None:
                            pspan.attributes["bytes"] = len(data)
                else:
                    data = await self._pull_remote(object_id, loc)
            except Exception:  # rtlint: disable=swallowed-exception - location failed: try the next replica
                continue
            if data is not None:
                try:
                    self.store.put(object_id, data)
                except FileExistsError:
                    pass
                except ObjectStoreFull:
                    return data  # serve from heap this once
                view = self.store.get(object_id, timeout_ms=0)
                return view if view is not None else data
        # All copies gone: attempt lineage reconstruction (owner-side only).
        if await self._try_reconstruct(object_id):
            state = self._objects[object_id]
            return (await self._payload_from_state(object_id, state))[0]
        raise exceptions.ObjectLostError(f"{object_id}: all copies lost")

    async def _pull_remote(self, object_id: str, loc: dict) -> bytes | None:
        cfg = global_config()
        client = await self._client_for((loc["agent_host"], loc["agent_port"]))
        chunks: list[bytes] = []
        offset = 0
        while True:
            resp = await client.call(
                "pull_object_chunk",
                {
                    "object_id": object_id,
                    "offset": offset,
                    "chunk": cfg.object_transfer_chunk_bytes,
                },
            )
            if resp["status"] != "ok":
                return None
            chunks.append(resp["data"])
            offset += len(resp["data"])
            if offset >= resp["total"]:
                break
        return b"".join(chunks)

    def _deserialize_value(self, object_id: str, payload, pinned: bool) -> Any:
        def resolver(ref_id: str, owner_address):
            ref = ObjectRef(ref_id, owner_address, runtime=self)
            self._note_borrow(ref_id, owner_address)
            return ref

        if pinned and len(payload) >= _ZERO_COPY_THRESHOLD:
            value = serialization.deserialize(payload, resolver, zero_copy=True)
            try:
                self.store.pin(object_id)
                store = self.store
                weakref.finalize(
                    value, _release_pinned, store, object_id
                )
                self.store.release(object_id)
                return value
            except TypeError:
                pass  # not weakref-able: fall through to copy
        value = serialization.deserialize(payload, resolver, zero_copy=False)
        if pinned:
            try:
                self.store.release(object_id)
            except Exception:  # rtlint: disable=swallowed-exception - release of a ref the store may have evicted
                pass
        return value

    def _note_borrow(self, object_id: str, owner_address) -> None:
        if owner_address is None or tuple(owner_address) == self.address:
            return
        if object_id in self._borrowed:
            return
        self._borrowed[object_id] = tuple(owner_address)
        self.io.spawn(self._register_borrow(object_id, tuple(owner_address)))

    async def _register_borrow(self, object_id: str, owner: tuple) -> None:
        try:
            client = await self._client_for(owner)
            await client.call(
                "add_borrower", {"object_id": object_id, "borrower": self.worker_id}
            )
        except Exception:  # rtlint: disable=swallowed-exception - owner death invalidates the borrow anyway
            pass

    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int = 1,
        timeout: float | None = None,
        fetch_local: bool = True,
    ) -> tuple[list[ObjectRef], list[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        if timeout is None and os.environ.get("RAY_TPU_debug_hang"):
            # Debug mode: an unbounded wait that exceeds 120s dumps the
            # submitter state once, then resumes waiting (same first-tool
            # role as the get() dump above).
            ready, not_ready = self.io.run(
                self._wait_async(list(refs), num_returns, 120.0)
            )
            if len(ready) >= num_returns:
                return ready, not_ready
            self._dump_hang_state([r.id for r in refs])
        return self.io.run(self._wait_async(list(refs), num_returns, timeout))

    async def _wait_async(self, refs, num_returns, timeout):
        tasks = {
            asyncio.ensure_future(self._wait_ready(ref)): ref for ref in refs
        }
        ready: list[ObjectRef] = []
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = set(tasks.keys())
        while pending and len(ready) < num_returns:
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            done, pending = await asyncio.wait(
                pending, timeout=remaining, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                # Retrieve exceptions: a ref whose owner is unreachable is
                # "ready" in the sense that get() won't block (it will raise
                # immediately) — same semantics the reference gives errored
                # objects in ray.wait.
                task.exception()
                ready.append(tasks[task])
            if deadline is not None and time.monotonic() >= deadline:
                break
        for task in pending:
            task.cancel()
        ready_set = {r.id for r in ready}
        not_ready = [r for r in refs if r.id not in ready_set]
        return ready, not_ready

    async def _wait_ready(self, ref: ObjectRef) -> None:
        state = self._objects.get(ref.id)
        if state is not None:
            await self._await_state(state)
            return
        client = await self._client_for(ref.owner_address)
        await client.call("wait_object", {"object_id": ref.id})

    # ------------------------------------------------------------------
    # direct-call lane — the native per-call hot path (N18/N19).
    #
    # Simple tasks (no ref args, default strategy/runtime-env) and actor
    # calls ride the C++ call table (src/rpc/transport.cc rt_call_*)
    # straight from the calling thread: spec encode (typed wire schema),
    # submit, reply matching, and inline-return settling never touch the
    # asyncio loop. Python keeps ONLY the scheduling policy (lease
    # acquisition via the asyncio path) and failure handling (fallback to
    # the asyncio machinery). Role split mirrors the reference's
    # normal_task_submitter.cc / actor_task_submitter.cc over C++ rpc.
    # ------------------------------------------------------------------
    def _direct_pick(self, key: str, spec: dict) -> "DirectWorker | None":
        """Least-loaded live direct worker for this resource shape, or
        None (caller falls back to the asyncio path). Triggers ASYNC pool
        growth so the next submits find capacity — never blocks."""
        cfg = global_config()
        now = time.monotonic()
        with self._direct_lock:
            pool = self._direct_pool.get(key)
            alive = [w for w in pool if not w.dead] if pool else []
            if pool is not None and len(alive) != len(pool):
                self._direct_pool[key] = alive
            best = min(alive, key=lambda w: w.inflight) if alive else None
            growing = self._direct_grows.get(key, 0)
            backoff_until = self._direct_backoff.get(key, 0.0)
            hint = self._lease_capacity_hint.get(
                key, self._MAX_DISPATCHERS_PER_KEY
            )
            cap = min(self._MAX_DISPATCHERS_PER_KEY, max(1, hint))
            # Grow on the NATIVE in-flight depth (calls still awaiting a
            # reply in the C++ table), not the Python uncollected count: a
            # burst of already-executed-but-not-yet-collected fast tasks
            # must not spawn workers the machine will only thrash between.
            want_grow = best is None or (
                best.inflight >= cfg.worker_pipeline_depth
                and len(alive) + growing < cap
                and self._engine.pylib.rt_conn_inflight(
                    self._engine.handle, best.conn_id
                ) >= cfg.worker_pipeline_depth
            )
            if (
                want_grow
                and now >= backoff_until
                and growing < 2
                and len(alive) + growing < cap
            ):
                self._direct_grows[key] = growing + 1
                self.io.spawn(self._direct_grow(key, dict(spec)))
            if best is not None:
                best.inflight += 1
                best.last_used = now
            return best

    async def _direct_grow(self, key: str, spec: dict) -> None:
        try:
            leased = await self._acquire_lease(spec)
            conn_id = getattr(leased.client, "_conn_id", None)
            if conn_id is None:  # asyncio-backend client: lane unusable
                await self._release_lease(leased, reusable=True)
                return
            dw = DirectWorker(leased, conn_id)
            with self._direct_lock:
                self._direct_pool.setdefault(key, []).append(dw)
            if not self._direct_reaper_started:
                self._direct_reaper_started = True
                spawn_task(self._direct_reaper())
        except Exception:
            # No capacity: back off so a hot submit loop doesn't churn
            # controller lease RPCs (the dispatcher's capacity-hint role).
            with self._direct_lock:
                self._direct_backoff[key] = time.monotonic() + 2.0
        finally:
            with self._direct_lock:
                self._direct_grows[key] = max(
                    0, self._direct_grows.get(key, 1) - 1
                )

    async def _direct_reaper(self) -> None:
        """Idle direct leases return to the agent after the grace period
        (raylet idle-lease grace role) so pool resources never strand."""
        grace = global_config().worker_lease_grace_s
        while not self._shutdown:
            await asyncio.sleep(max(grace, 0.1))
            now = time.monotonic()
            to_release = []
            with self._direct_lock:
                for key, pool in list(self._direct_pool.items()):
                    keep = []
                    for dw in pool:
                        if dw.dead:
                            continue
                        if dw.inflight == 0 and now - dw.last_used > grace:
                            to_release.append(dw)
                        else:
                            keep.append(dw)
                    self._direct_pool[key] = keep
            for dw in to_release:
                try:
                    await self._release_lease(dw.leased, reusable=True)
                except Exception:  # rtlint: disable=swallowed-exception - idle lease release; agent may be gone
                    pass

    def _direct_note_dead(self, dw: DirectWorker) -> None:
        dw.dead = True
        with self._direct_lock:
            pool = self._direct_pool.get(dw.leased.resources_key)
            if pool and dw in pool:
                pool.remove(dw)
        try:
            self.io.spawn(self._release_lease(dw.leased, reusable=False))
        except RuntimeError:
            pass

    def _direct_submit(
        self, key: str, record: PendingTask, parts: tuple | None = None
    ) -> bool:
        """Put a simple task on the wire via the native call table from
        THIS thread. False = caller must use the asyncio path."""
        engine = self._engine
        if engine is None:
            return False
        worker = self._direct_pick(key, record.spec)
        if worker is None:
            return False
        fl = self._fastlane
        if fl is not None and parts is not None:
            # One C call: splice the canonical payload from the precompiled
            # template parts + start the native call (buffered in bursts).
            handle = fl.submit(
                engine.handle, worker.conn_id, b"push_task",
                parts[0], record.spec["task_id"], parts[1],
                record.spec["args"], parts[2], 0, -1,
                1 if self._direct_unsettled >= 2 else 0,
            )
        else:
            payload = wire_gen.encode_task_spec(record.spec)
            lib = (
                engine.pylib
                if len(payload) < engine._PYLIB_MAX_PAYLOAD
                else engine.lib
            )
            starter = (
                lib.rt_call_start_buf
                if self._direct_unsettled >= 2
                else lib.rt_call_start
            )
            handle = starter(
                engine.handle, worker.conn_id, b"push_task", 9,
                payload, len(payload),
            )
        if handle == 0:
            with self._direct_lock:
                worker.inflight -= 1
            self._direct_note_dead(worker)
            return False
        self._direct_unsettled += 1
        record.make_direct()
        record.attempts = 1
        record.native_handle = handle
        record.direct_worker = worker
        for rid in record.return_ids:
            state = self._objects.get(rid)
            if state is not None:
                state.record = record
        self._running_tasks[record.spec["task_id"]] = worker.leased.client
        return True

    def _settle_native(
        self, record: PendingTask, timeout: float | None
    ) -> bool:
        """Drive a direct-lane record to completion from THIS thread
        (blocking, GIL released inside rt_call_wait). True = settled;
        False = timeout. Safe under contention: the first settler consumes
        the native handle, everyone else waits on record.done_event."""
        import ctypes

        from ray_tpu_torch import _native

        deadline = None if timeout is None else time.monotonic() + timeout
        engine = self._engine
        while not record.done:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
            acquired = record.settle_lock.acquire(
                timeout=-1 if remaining is None else remaining
            )
            if not acquired:
                return False
            settled_here = False
            try:
                if record.done:
                    return True
                handle = record.native_handle
                if handle is not None:
                    timeout_ms = (
                        -1 if remaining is None else max(1, int(remaining * 1000))
                    )
                    fl = self._fastlane
                    if fl is not None:
                        # C-side wait + reply decode: the common ok/inline
                        # case comes back as ready-to-store bytes.
                        res = fl.call_wait(engine.handle, handle, timeout_ms)
                        rc = res[0]
                        if rc == 0:
                            return False
                        record.native_handle = None
                        self._direct_unsettled = max(
                            0, self._direct_unsettled - 1
                        )
                        if rc == 1:
                            settled_here = self._direct_reply_inline(
                                record, res[1]
                            )
                        elif rc == 2:
                            settled_here = self._direct_reply(
                                record, REP, res[1]
                            )
                        elif rc == 3:
                            settled_here = self._direct_reply(
                                record, ERR, res[1]
                            )
                        elif rc == -1:
                            settled_here = self._direct_conn_lost(record)
                        # rc == -2: someone else consumed the handle —
                        # fall through to done_event below.
                    else:
                        view = _native.RtMsgView()
                        rc = engine.lib.rt_call_wait(
                            engine.handle, handle, timeout_ms,
                            ctypes.byref(view),
                        )
                        if rc == 0:
                            return False
                        record.native_handle = None
                        self._direct_unsettled = max(
                            0, self._direct_unsettled - 1
                        )
                        if rc == 1:
                            kind = view.kind
                            raw = (
                                ctypes.string_at(view.payload, view.plen)
                                if view.plen
                                else b""
                            )
                            engine.pylib.rt_msg_free(view.opaque)
                            settled_here = self._direct_reply(
                                record, kind, raw
                            )
                        elif rc == -1:
                            settled_here = self._direct_conn_lost(record)
                        # rc == -2: someone else consumed the handle — fall
                        # through to done_event below.
            finally:
                record.settle_lock.release()
            if settled_here or record.done:
                return True
            # The record is now owned by the asyncio machinery (retry /
            # actor protocol): wait for _finish_record / _run_actor_task.
            wait_s = None
            if deadline is not None:
                wait_s = max(0.0, deadline - time.monotonic())
            if not record.done_event.wait(wait_s):
                return False
        return True

    def _direct_reply_inline(self, record: PendingTask, data: bytes) -> bool:
        """Slim settle for the dominant reply shape (status ok, one inline
        return, already isolated by the C-side scan): store the bytes and
        finish the record without building a reply dict. Mirrors
        _direct_reply + _finish_record for that shape exactly."""
        if len(record.return_ids) != 1:
            # Expected-returns mismatch: take the generic path (it zips
            # and fails/fills per state like the asyncio machinery).
            return self._direct_reply(
                record,
                REP,
                wire_gen.encode_task_reply(
                    {"status": "ok",
                     "returns": [{"kind": "inline", "data": data}]}
                ),
            )
        dw = record.direct_worker
        if dw is not None:
            record.direct_worker = None
            with self._direct_lock:
                dw.inflight -= 1
                dw.last_used = time.monotonic()
        spec = record.spec
        task_id = spec["task_id"]
        self._running_tasks.pop(task_id, None)
        if record.done:
            return True
        record.done = True
        self._task_records.pop(task_id, None)
        self._cancelled_tasks.discard(task_id)
        state = self._objects.get(record.return_ids[0])
        if state is not None:
            state.status = INLINE
            state.data = data
            state.size = len(data)
            state.record = None
            self._set_state_event(state)
        if record.done_event is not None:
            record.done_event.set()
        if record.arg_refs:
            with self._refs_lock:
                for rid in record.arg_refs:
                    count = self._submitted_refs.get(rid, 0) - 1
                    if count <= 0:
                        self._submitted_refs.pop(rid, None)
                    else:
                        self._submitted_refs[rid] = count
            for rid in record.arg_refs:
                self._maybe_free(rid)
        return True

    def _direct_reply(self, record: PendingTask, kind: int, raw: bytes) -> bool:
        """Apply a native reply frame. True = record finished; False =
        requeued through the asyncio path (retry_exceptions)."""
        dw = record.direct_worker
        if dw is not None:
            record.direct_worker = None
            with self._direct_lock:
                dw.inflight -= 1
                dw.last_used = time.monotonic()
        spec = record.spec
        task_id = spec["task_id"]
        self._running_tasks.pop(task_id, None)
        if kind == ERR:
            self._finish_record(
                record,
                error=exceptions.WorkerCrashedError(
                    f"task {spec['name']}: remote dispatch error: "
                    f"{raw[:300]!r}"
                ),
            )
            return True
        reply = wire_gen.decode_task_reply(raw)
        if reply["status"] == "cancelled":
            self._finish_record(
                record,
                error=exceptions.TaskCancelledError(
                    f"task {spec['name']} was cancelled"
                ),
            )
            return True
        if (
            reply["status"] == "error"
            and spec.get("retry_exceptions")
            and record.attempts <= spec.get("max_retries", 0)
            and task_id not in self._cancelled_tasks
            and not spec.get("actor_id")
        ):
            try:
                self.io.loop.call_soon_threadsafe(self._enqueue_task, record)
                return False
            except RuntimeError:
                pass
        self._finish_record(record, reply=reply)
        return True

    def _direct_conn_lost(self, record: PendingTask) -> bool:
        """Native call failed with connection loss: apply the same policy
        as the asyncio submitter (_push_one / _run_actor_task). True =
        record finished here; False = handed to the asyncio machinery."""
        dw = record.direct_worker
        if dw is not None:
            record.direct_worker = None
            with self._direct_lock:
                dw.inflight -= 1
            self._direct_note_dead(dw)
        spec = record.spec
        task_id = spec["task_id"]
        self._running_tasks.pop(task_id, None)
        if task_id in self._cancelled_tasks:
            self._finish_record(
                record,
                error=exceptions.WorkerCrashedError(
                    f"task {spec['name']} force-cancelled"
                ),
            )
            return True
        if spec.get("actor_id"):
            # Actor protocol (controller consult / restart retry) lives in
            # _run_actor_task — replay the record through it.
            try:
                self.io.loop.call_soon_threadsafe(
                    lambda: spawn_task(self._run_actor_task(record))
                )
                return False
            except RuntimeError:
                pass
        elif record.attempts <= spec.get("max_retries", 0):
            try:
                self.io.loop.call_soon_threadsafe(self._enqueue_task, record)
                return False
            except RuntimeError:
                pass
        elif dw is not None:
            # Final failure: attribute the death (OOM vs crash) on the io
            # loop — the tombstone query is an RPC. Caller waits on
            # done_event; _finish_record sets it.
            leased = dw.leased

            async def _finish_attributed():
                self._finish_record(
                    record,
                    error=await self._worker_failure_error(
                        leased, spec, record.attempts,
                        "connection to worker lost",
                    ),
                )

            try:
                self.io.loop.call_soon_threadsafe(
                    lambda: spawn_task(_finish_attributed())
                )
                return False
            except RuntimeError:
                pass
        self._finish_record(
            record,
            error=exceptions.WorkerCrashedError(
                f"task {spec['name']} failed after {record.attempts} "
                f"attempts: connection to worker lost"
            ),
        )
        return True

    def _direct_abandon(self, record: PendingTask) -> None:
        """Release a direct-lane record nobody will settle (all return
        refs dropped). Safe: with zero live refs there can be no
        concurrent settler (settlers hold a ref)."""
        with record.settle_lock:
            if record.done:
                return
            handle = record.native_handle
            record.native_handle = None
            if handle is not None:
                engine = self._engine
                if engine is not None and engine.handle:
                    engine.pylib.rt_call_abandon(engine.handle, handle)
                self._direct_unsettled = max(0, self._direct_unsettled - 1)
            dw = record.direct_worker
            record.direct_worker = None
            if dw is not None:
                with self._direct_lock:
                    dw.inflight -= 1
                    dw.last_used = time.monotonic()
            record.done = True
            task_id = record.spec.get("task_id")
            self._task_records.pop(task_id, None)
            self._running_tasks.pop(task_id, None)
            if record.done_event is not None:
                record.done_event.set()

    async def _settle_native_async(self, record: PendingTask) -> None:
        """Loop-side access to a direct-lane record: drive completion on
        an executor thread (rt_call_wait must never block the io loop)."""
        if record.done:
            return
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._settle_native, record, None)

    async def _await_state(self, state: ObjectState) -> None:
        """Wait until `state` settles, driving direct-lane records to
        completion (their replies sit in the C++ call table until someone
        collects — a bare event.wait would park forever)."""
        if state.status != PENDING:
            return
        record = state.record
        if record is not None and record.direct:
            await self._settle_native_async(record)
            return
        state.waited = True
        if state.status != PENDING:  # settled between check and flag
            return
        await state.event.wait()

    def _get_direct(self, ref_list, timeout):
        """All-local fast get: settle direct-lane records and read local
        payloads entirely on the calling thread. Returns _DIRECT_MISS to
        fall back to the asyncio path for anything it cannot prove local
        (partial settling is fine — the asyncio path is idempotent)."""
        states = []
        for ref in ref_list:
            state = self._objects.get(ref.id)
            if state is None:
                return _DIRECT_MISS
            if state.status == PENDING and (
                state.record is None or not state.record.direct
            ):
                return _DIRECT_MISS
            states.append(state)
        deadline = None if timeout is None else time.monotonic() + timeout
        for ref, state in zip(ref_list, states):
            while state.status == PENDING:
                record = state.record
                if record is None or not record.direct:
                    return _DIRECT_MISS
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise exceptions.GetTimeoutError(
                            f"get() timed out after {timeout}s"
                        )
                if not self._settle_native(record, remaining):
                    if os.environ.get("RAY_TPU_debug_hang"):
                        self._dump_hang_state([r.id for r in ref_list])
                    raise exceptions.GetTimeoutError(
                        f"get() timed out after {timeout}s"
                    )
        values = []
        for ref, state in zip(ref_list, states):
            if state.status == FAILED:
                self._raise_stored_error(state.error)
            if state.status == INLINE:
                values.append(
                    self._deserialize_value(ref.id, state.data, False)
                )
                continue
            # SHM: serve only local-store hits on this thread.
            view = self.store.get(ref.id, timeout_ms=0)
            if view is None:
                local = any(
                    loc.get("node_id") == self.node_id
                    for loc in state.locations
                )
                view = (
                    self.store.get(ref.id, timeout_ms=2000) if local else None
                )
            if view is None:
                return _DIRECT_MISS
            values.append(self._deserialize_value(ref.id, view, True))
        return values

    # ------------------------------------------------------------------
    # task submission (N19/N22)
    # ------------------------------------------------------------------
    def next_task_id(self) -> TaskID:
        with self._counter_lock:
            self._task_counter += 1
            return TaskID(f"tsk-{self.worker_id[4:]}-{self._task_counter}")

    def make_spec_template(
        self,
        *,
        function_id: str,
        name: str,
        num_returns: int = 1,
        resources: dict | None = None,
        max_retries: int | None = None,
        retry_exceptions: bool = False,
        runtime_env: dict | None = None,
        scheduling_strategy: Any = None,
    ) -> dict:
        """Static spec fields for a (function, options) pair — cached by
        RemoteFunction so each submit pays one dict copy, not a rebuild
        (the reference caches its TaskSpec builder the same way)."""
        cfg = global_config()
        template = {
            "task_id": "",
            "job_id": self.job_id,
            "function_id": function_id,
            "name": name,
            "args": b"",
            "num_returns": num_returns,
            "resources": resources or {"CPU": 1},
            "owner": {"worker_id": self.worker_id, "address": list(self.address)},
            "runtime_env": runtime_env or {},
            "scheduling_strategy": _encode_strategy(scheduling_strategy),
            "max_retries": (
                cfg.task_max_retries_default if max_retries is None else max_retries
            ),
            "retry_exceptions": retry_exceptions,
            "has_ref_args": False,
        }
        # Precompiled splice parts: the direct lane re-encodes only
        # (task_id, args) per submit. Computed BEFORE the private keys
        # below join the dict — unknown keys would pass through to p2.
        template["_parts"] = wire_gen.make_task_spec_parts(template)
        # direct-pool key, precomputed (popped before the wire)
        template["_dkey"] = _resources_key(
            resources or {"CPU": 1}, repr(runtime_env or {})
        )
        # dispatcher-queue key, also template-static: at 100k queued
        # tasks the per-submit repr() rebuilds in _enqueue_task dominate
        # the enqueue path, so pay them once per (function, options).
        template["_qkey"] = template["_dkey"] + repr(
            sorted((template["scheduling_strategy"] or {}).items())
        )
        return template

    def submit_task(
        self,
        *,
        function_id: str = "",
        name: str = "",
        args: tuple = (),
        kwargs: dict | None = None,
        num_returns: int = 1,
        resources: dict | None = None,
        max_retries: int | None = None,
        retry_exceptions: bool = False,
        runtime_env: dict | None = None,
        scheduling_strategy: Any = None,
        spec_template: dict | None = None,
    ) -> list[ObjectRef]:
        task_id = self.next_task_id()
        if not args and not kwargs:
            payload, contained = serialization.EMPTY_ARGS_PAYLOAD, ()
        else:
            payload, contained = serialization.serialize((args, kwargs or {}))
        arg_ref_ids = [r.id for r in contained]
        # Submitted-task references: args stay alive until the task finishes.
        if arg_ref_ids:
            with self._refs_lock:
                for rid in arg_ref_ids:
                    self._submitted_refs[rid] = (
                        self._submitted_refs.get(rid, 0) + 1
                    )
        if spec_template is not None:
            spec = dict(spec_template)
            num_returns = spec["num_returns"]
        else:
            spec = self.make_spec_template(
                function_id=function_id,
                name=name,
                num_returns=num_returns,
                resources=resources,
                max_retries=max_retries,
                retry_exceptions=retry_exceptions,
                runtime_env=runtime_env,
                scheduling_strategy=scheduling_strategy,
            )
        direct_key = spec.pop("_dkey", None)
        queue_key = spec.pop("_qkey", None)
        spec_parts = spec.pop("_parts", None)
        return_ids = [
            ObjectID.for_task_return(task_id, i) for i in range(num_returns)
        ]
        spec["task_id"] = task_id
        spec["args"] = payload
        # Workers use this hint to route ref-carrying tasks off the fast
        # execution lane (dependency resolution must not block the main
        # lane — see worker_proc).
        spec["has_ref_args"] = bool(arg_ref_ids)
        submit_span = None
        if tracing.enabled():
            # Submit span: its context rides in the spec so the worker's
            # execute span becomes this one's child (SURVEY §5.1). Uses
            # the begin/finish fast path — this runs once per task on the
            # submitting thread, and the span closes after the handoff to
            # the io loop so it covers the whole client-side submit cost.
            submit_span = tracing.begin(
                f"submit {spec['name']}", task_id=task_id
            )
            spec["trace_ctx"] = {
                "trace_id": submit_span.trace_id,
                "span_id": submit_span.span_id,
            }
        record = PendingTask(spec, return_ids, arg_ref_ids)
        record.queue_key = queue_key
        self._task_records[task_id] = record
        refs = []
        for rid in return_ids:
            state = ObjectState()
            self._objects[rid] = state
            if global_config().lineage_pinning_enabled:
                self._lineage[rid] = record
            refs.append(self.new_object_ref(rid))
        # Direct lane: simple tasks ride the native call table from this
        # very thread — no loop handoff, no dispatcher (N19 direct calls).
        if (
            self._engine is not None
            and not arg_ref_ids
            and not spec["scheduling_strategy"]
            and not spec["runtime_env"]
            and "trace_ctx" not in spec
        ):
            if direct_key is None:
                direct_key = _resources_key(
                    spec["resources"], repr(spec["runtime_env"])
                )
            if self._direct_submit(direct_key, record, spec_parts):
                return refs
        # Batched handoff to the io loop: appending to a deque and waking
        # the loop once per burst (scheduled only on the empty->nonempty
        # edge, under a lock so concurrent submitters can't both skip the
        # wakeup) costs ~1 loop wakeup per BATCH of submits instead of one
        # run_coroutine_threadsafe (~100 us measured on 1-core hosts) per
        # task.
        with self._submit_lock:
            self._submit_buf.append(record)
            need_schedule = not self._submit_scheduled
            self._submit_scheduled = True
        if need_schedule:
            self.io.loop.call_soon_threadsafe(self._drain_submit_buf)
        if submit_span is not None:
            tracing.finish(submit_span)
        return refs

    # The submitter keeps a per-(resources, runtime_env) task queue drained by
    # dispatcher coroutines that each hold one worker lease and pipeline tasks
    # through it — the lease-reuse behavior of normal_task_submitter.cc.
    _MAX_DISPATCHERS_PER_KEY = 16

    def _drain_submit_buf(self) -> None:
        """Runs on the io loop: moves buffered records into their queues."""
        while True:
            with self._submit_lock:
                if not self._submit_buf:
                    self._submit_scheduled = False
                    return
                record = self._submit_buf.popleft()
            self._enqueue_task(record)

    def _enqueue_task(self, record: PendingTask) -> None:
        spec = record.spec
        key = record.queue_key
        if key is None:
            strategy = spec.get("scheduling_strategy") or {}
            key = _resources_key(
                spec["resources"], repr(spec["runtime_env"])
            ) + repr(sorted(strategy.items()))
        queue = self._task_queues.get(key)
        if queue is None:
            queue = self._task_queues[key] = asyncio.Queue()
        queue.put_nowait(record)
        active = self._active_dispatchers.get(key, 0)
        # Dispatcher spawn policy: bounded by queue depth, the hard cap, and
        # the learned capacity hint — when lease acquisition came back
        # "busy" at N holders, spawning an (N+1)-th dispatcher just churns
        # controller lease RPCs. Probe past the hint occasionally so the
        # hint recovers when the cluster grows.
        hint = self._lease_capacity_hint.get(key, self._MAX_DISPATCHERS_PER_KEY)
        self._enqueue_counter += 1
        if self._enqueue_counter % 64 == 0:
            hint += 1  # periodic probe beyond the learned capacity
        if active < min(queue.qsize(), self._MAX_DISPATCHERS_PER_KEY, hint):
            self._active_dispatchers[key] = active + 1
            spawn_task(self._dispatcher(key, queue))

    async def _dispatcher(self, key: str, queue: asyncio.Queue) -> None:
        """Holds one worker lease and PIPELINES tasks through it: up to
        ``worker_pipeline_depth`` pushes in flight before awaiting replies
        (normal_task_submitter pipelining role) — per-task wakeups and
        syscalls amortize across the window."""
        worker: LeasedWorker | None = None
        lease_failures = 0
        inflight: set = set()  # asyncio.Tasks running _push_one

        async def drain_one() -> None:
            # Await one completion; a lost result names the worker that
            # died — drop that lease ONLY if it is still the current one
            # (a stale loss from an already-replaced worker must not
            # release the healthy replacement lease).
            nonlocal worker, inflight
            done, inflight = await asyncio.wait(
                inflight, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                lost = task.result()
                if lost is not None and lost is worker:
                    await self._release_lease(worker, reusable=False)
                    worker = None

        try:
            while True:
                if worker is None:
                    if queue.empty():
                        if inflight:
                            await drain_one()
                            continue
                        return
                    # Acquire BEFORE popping so a blocked acquire (e.g. the
                    # agent queueing lease requests while it spawns
                    # workers) never holds a task hostage — other
                    # dispatchers keep draining the queue meanwhile.
                    spec_peek = queue._queue[0].spec  # safe: single loop
                    try:
                        worker = await self._acquire_lease(spec_peek)
                        lease_failures = 0
                        # Raise a LEARNED hint when concurrency above it
                        # succeeds (e.g. the cluster grew); an absent hint
                        # already means "uncapped" — never lower it here.
                        hint = self._lease_capacity_hint.get(key)
                        active = self._active_dispatchers.get(key, 1)
                        if hint is not None and active > hint:
                            self._lease_capacity_hint[key] = active
                    except Exception as exc:
                        lease_failures += 1
                        if self._active_dispatchers.get(key, 1) > 1:
                            # Learn the capacity: the other holders ARE the
                            # cluster's current parallelism for this shape,
                            # and this excess dispatcher exits rather than
                            # churning controller lease RPCs.
                            self._lease_capacity_hint[key] = max(
                                1, self._active_dispatchers.get(key, 1) - 1
                            )
                            return
                        if lease_failures >= 5:
                            # Can't get capacity: fail one task and keep
                            # trying so an infeasible queue eventually
                            # drains with errors rather than hanging.
                            try:
                                record = queue.get_nowait()
                            except asyncio.QueueEmpty:
                                return
                            self._finish_record(
                                record,
                                error=exceptions.WorkerCrashedError(
                                    f"task {record.spec['name']}: no worker "
                                    f"lease after {lease_failures} attempts: {exc}"
                                ),
                            )
                            lease_failures = 0
                            continue
                        await asyncio.sleep(min(0.2 * lease_failures, 2.0))
                    continue
                try:
                    record = queue.get_nowait()
                except asyncio.QueueEmpty:
                    if inflight:
                        await drain_one()
                        continue
                    # Keep the lease warm for a grace period: the next
                    # same-shape task (e.g. a sync submit loop) reuses this
                    # worker with zero lease RPCs (the raylet's idle lease
                    # grace / lease-reuse role).
                    try:
                        record = await asyncio.wait_for(
                            queue.get(), global_config().worker_lease_grace_s
                        )
                    except (asyncio.TimeoutError, TimeoutError):
                        return
                if record.done or record.spec["task_id"] in self._cancelled_tasks:
                    # cancel() already failed the returns while we queued.
                    continue
                if not inflight and queue.empty():
                    # Sequential fast path (sync submit loops): await the
                    # push directly — no task object, no asyncio.wait
                    # machinery, identical latency to an inline call.
                    lost = await self._push_one(worker, queue, record)
                    if lost is not None and lost is worker:
                        await self._release_lease(worker, reusable=False)
                        worker = None
                    continue
                inflight.add(spawn_task(self._push_one(worker, queue, record)))
                if len(inflight) >= global_config().worker_pipeline_depth:
                    await drain_one()
        finally:
            if inflight:
                await asyncio.wait(inflight)
            self._active_dispatchers[key] = self._active_dispatchers.get(key, 1) - 1
            if worker is not None:
                await self._release_lease(worker, reusable=True)
            # Self-heal: retries requeued during teardown (e.g. from the
            # inflight wait above) must not strand in a dispatcher-less
            # queue until some unrelated future submit of the same key.
            if not queue.empty() and self._active_dispatchers.get(key, 0) <= 0:
                self._active_dispatchers[key] = 1
                spawn_task(self._dispatcher(key, queue))

    # (direct-lane records that fall back re-enter through _enqueue_task;
    # their done_event is set by _finish_record when the asyncio side
    # settles them.)

    def _maybe_push_args(self, record: PendingTask, worker: LeasedWorker) -> None:
        """Submit-time locality hints (push_manager.cc role): large SHM
        args this driver owns that have no copy on the target worker's
        node are pushed agent→agent (C++ chunk plane) while the task
        travels — by the time the worker resolves its args, the bytes are
        usually already local. Fire-and-forget: pull remains the
        fallback."""
        if not record.arg_refs:
            return
        cfg = global_config()
        if not cfg.push_transfers_enabled:
            return
        target = tuple(worker.agent_addr or ())
        if len(target) != 2 or target == tuple(self.agent_addr):
            return
        for rid in record.arg_refs:
            state = self._objects.get(rid)
            if (
                state is None
                or state.status != SHM
                or state.size < cfg.push_transfer_min_bytes
                or not state.locations
            ):
                continue
            if any(
                (loc.get("agent_host"), loc.get("agent_port")) == target
                for loc in state.locations
            ):
                continue  # already local to the target node
            self.io.spawn(self._push_hint(rid, state.locations[0], target))

    async def _push_hint(self, object_id: str, src: dict, target: tuple) -> None:
        try:
            client = await self._client_for(
                (src["agent_host"], src["agent_port"])
            )
            scope = (
                tracing.span(
                    "object_push", object_id=object_id,
                    src_node=src.get("node_id"), dst=f"{target[0]}:{target[1]}",
                )
                if tracing.enabled()
                else contextlib.nullcontext()
            )
            with scope:
                await client.call(
                    "push_object",
                    {
                        "object_id": object_id,
                        "target_host": target[0],
                        "target_port": target[1],
                    },
                    timeout=60,
                )
        except Exception:  # rtlint: disable=swallowed-exception - opportunistic push; pull path still serves the object
            pass  # opportunistic: the pull path still serves the object

    async def _push_one(
        self, worker: LeasedWorker, queue: asyncio.Queue, record: PendingTask
    ) -> "LeasedWorker | None":
        """Push one task to a leased worker and settle its record.
        Returns the worker when its connection died (so the dispatcher can
        drop exactly that lease), else None; on loss this record was
        requeued/failed here according to its retry budget."""
        spec = record.spec
        task_id = spec["task_id"]
        record.attempts += 1
        self._running_tasks[task_id] = worker.client
        self._maybe_push_args(record, worker)
        try:
            reply = await worker.client.call("push_task", spec)
        except (ConnectionLost, RpcError, OSError) as exc:
            if task_id in self._cancelled_tasks:
                # force=True cancellation kills the worker; surface the
                # reference's WorkerCrashedError, never retry.
                self._finish_record(
                    record,
                    error=exceptions.WorkerCrashedError(
                        f"task {spec['name']} force-cancelled"
                    ),
                )
            elif record.attempts <= spec["max_retries"]:
                queue.put_nowait(record)
            else:
                self._finish_record(
                    record,
                    error=await self._worker_failure_error(
                        worker, spec, record.attempts, exc
                    ),
                )
            return worker
        except Exception as exc:  # never kill the dispatcher silently
            traceback.print_exc()
            self._finish_record(
                record,
                error=exceptions.WorkerCrashedError(
                    f"task {spec['name']}: submitter error: {exc!r}"
                ),
            )
            return None
        finally:
            self._running_tasks.pop(task_id, None)
        if reply.get("status") == "cancelled":
            self._finish_record(
                record,
                error=exceptions.TaskCancelledError(
                    f"task {spec['name']} was cancelled"
                ),
            )
            return None
        if (
            reply.get("status") == "error"
            and spec["retry_exceptions"]
            and record.attempts <= spec["max_retries"]
            and task_id not in self._cancelled_tasks
        ):
            queue.put_nowait(record)
            return None
        self._finish_record(record, reply=reply)
        return None

    async def _worker_failure_error(
        self, worker: "LeasedWorker", spec: dict, attempts: int, exc
    ) -> Exception:
        """Attribute a worker death: the node agent's memory monitor
        leaves a tombstone, so an OOM kill surfaces as the distinct
        (retriable, system-level) OutOfMemoryError instead of a generic
        crash (reference memory_monitor.cc / raylet OOM policy, N15).
        The tombstone may land moments after the conn drops — poll
        briefly."""
        reason = rss = None
        try:
            agent = await self._client_for(worker.agent_addr)
            for _ in range(8):
                info = await agent.call(
                    "worker_death_info",
                    {"worker_id": worker.worker_id},
                    timeout=5,
                )
                detail = info.get("info")
                if detail:
                    reason = detail.get("reason")
                    rss = detail.get("rss")
                    break
                if info.get("alive"):
                    break  # no death, no tombstone coming — stop polling
                await asyncio.sleep(0.25)
        except Exception:  # rtlint: disable=swallowed-exception - death-info poll only enriches the error message
            pass
        if reason == "oom":
            mib = f" (rss {rss >> 20} MiB)" if rss else ""
            return exceptions.OutOfMemoryError(
                f"task {spec['name']}: worker {worker.worker_id} was killed "
                f"by the node memory monitor{mib} after {attempts} attempts"
            )
        return exceptions.WorkerCrashedError(
            f"task {spec['name']} failed after {attempts} attempts: {exc}"
        )

    def _finish_record(
        self,
        record: PendingTask,
        reply: dict | None = None,
        error: Exception | None = None,
    ) -> None:
        if record.done:
            return
        record.done = True
        task_id = record.spec.get("task_id")
        self._task_records.pop(task_id, None)
        self._cancelled_tasks.discard(task_id)
        if error is not None:
            self._fail_returns(record, error)
        else:
            self._apply_reply(record, reply)
        if record.done_event is not None:
            record.done_event.set()
        with self._refs_lock:
            for rid in record.arg_refs:
                count = self._submitted_refs.get(rid, 0) - 1
                if count <= 0:
                    self._submitted_refs.pop(rid, None)
                else:
                    self._submitted_refs[rid] = count
        for rid in record.arg_refs:
            self._maybe_free(rid)

    def cancel(self, ref, force: bool = False) -> None:
        """Best-effort task cancellation (reference: CoreWorker::CancelTask;
        semantics of python/ray/tests/test_cancel.py): a queued task is
        dequeued and its refs fail with TaskCancelledError; a running task
        gets KeyboardInterrupt raised in its executing thread (force=False)
        or its worker process SIGKILLed (force=True, refs fail with
        WorkerCrashedError); a finished task is a no-op."""
        self.io.run(self._cancel_async(ref.id, force))

    async def _cancel_async(self, obj_id: str, force: bool) -> None:
        oid = ObjectID(obj_id)
        task_id = oid.creating_task_id()
        # for_put ids also embed a task id; only task RETURNS ("-rN") are
        # cancellable (reference: ray.cancel rejects ray.put refs).
        if task_id is None or not obj_id.rsplit("-", 1)[-1].startswith("r"):
            raise ValueError("only task-return refs can be cancelled")
        state = self._objects.get(obj_id)
        if state is not None and state.status != PENDING:
            return  # already finished: no-op
        self._cancelled_tasks.add(task_id)
        client = self._running_tasks.get(task_id)
        if client is not None:
            try:
                await client.call(
                    "cancel_task", {"task_id": task_id, "force": force},
                    timeout=5,
                )
            except Exception:  # rtlint: disable=swallowed-exception - worker died (force) or finished concurrently
                pass  # worker died (force) or finished concurrently
            return
        record = self._task_records.get(task_id)
        if record is not None:
            self._finish_record(
                record,
                error=exceptions.TaskCancelledError(
                    f"task {record.spec['name']} was cancelled before it started"
                ),
            )

    async def _acquire_lease(self, spec: dict) -> LeasedWorker:
        key = _resources_key(spec["resources"], repr(spec["runtime_env"]))
        strategy = spec.get("scheduling_strategy") or {}
        assert self.controller is not None
        # Carry the triggering task's trace context into the control plane
        # so controller lease_wait / agent worker_start spans attach to the
        # same trace (best-effort causal attribution: the lease is reused
        # by later tasks, but THIS task paid the wait).
        trace_ctx = spec.get("trace_ctx") if tracing.enabled() else None
        lease_payload = {
            "resources": spec["resources"],
            "job_id": spec["job_id"],
            "submitter_node": self.node_id,
            "scheduling_strategy": strategy,
        }
        if trace_ctx:
            lease_payload["trace_ctx"] = trace_ctx
        resp = await self.controller.call("request_lease", lease_payload)
        if resp.get("status") != "ok":
            raise RuntimeError(f"lease request failed: {resp.get('status')}")
        agent_addr = tuple(resp["agent_addr"])
        agent = await self._client_for(agent_addr)
        worker_payload = {
            "resources": spec["resources"],
            "runtime_env": spec["runtime_env"],
            "job_id": spec["job_id"],
            "bundle": resp.get("bundle"),
        }
        if trace_ctx:
            worker_payload["trace_ctx"] = trace_ctx
        lease = await agent.call("lease_worker", worker_payload)
        if lease.get("status") != "ok":
            raise RuntimeError(
                f"worker lease failed: {lease.get('status')} {lease.get('error', '')}"
            )
        client = await self._client_for(tuple(lease["worker_addr"]))
        return LeasedWorker(
            lease["worker_id"],
            tuple(lease["worker_addr"]),
            client,
            lease["lease_id"],
            agent_addr,
            key,
        )

    async def _release_lease(self, worker: LeasedWorker, reusable: bool) -> None:
        # Always hand the lease back: the agent keeps the worker process warm
        # in its pool, so the next lease is cheap, and the node's resources
        # are never held hostage by an idle submitter (worker_pool.cc [N11]).
        # reusable=False tells the agent NOT to pool the worker (we saw its
        # connection die) — pooling it would burn the next lease's tasks.
        try:
            agent = await self._client_for(worker.agent_addr)
            await agent.call(
                "return_worker",
                {"lease_id": worker.lease_id, "reusable": reusable},
            )
        except Exception:  # rtlint: disable=swallowed-exception - agent gone: the lease died with it
            pass

    def _set_state_event(self, state: ObjectState) -> None:
        """Settle notification that is safe from ANY thread: on the io
        loop, set directly; from a caller thread, wake the loop only when
        someone actually parked on the event (state.waited) — an
        unconditional call_soon_threadsafe would cost one loop wakeup per
        task on the direct lane."""
        try:
            on_loop = asyncio.get_running_loop() is self.io.loop
        except RuntimeError:
            on_loop = False
        if on_loop:
            state.event.set()
        elif state.waited:
            try:
                self.io.loop.call_soon_threadsafe(state.event.set)
            except RuntimeError:
                pass  # loop already closed (shutdown)

    def _apply_reply(self, record: PendingTask, reply: dict) -> None:
        if reply.get("status") == "error":
            self._fail_returns_payload(record, reply["error"])
            return
        for rid, result in zip(record.return_ids, reply["returns"]):
            state = self._objects.get(rid)
            if state is None:
                continue
            if result["kind"] == "inline":
                state.status = INLINE
                state.data = result["data"]
                state.size = len(result["data"])
            else:
                state.status = SHM
                state.size = result["size"]
                state.locations = [result["location"]]
            state.record = None
            self._set_state_event(state)

    def _fail_returns(self, record: PendingTask, exc: Exception) -> None:
        payload, _ = serialization.serialize(exc)
        self._fail_returns_payload(record, payload)

    def _fail_returns_payload(self, record: PendingTask, error_payload) -> None:
        for rid in record.return_ids:
            state = self._objects.get(rid)
            if state is None:
                continue
            state.status = FAILED
            state.error = error_payload
            state.record = None
            self._set_state_event(state)

    async def _try_reconstruct(self, object_id: str) -> bool:
        """Object recovery via lineage re-execution ([N23]): reset the return
        states to PENDING and resubmit the creating task through the normal
        dispatch queue, then wait for it to finish."""
        record = self._lineage.get(object_id)
        if record is None or record.spec.get("actor_id"):
            return False
        fresh = PendingTask(record.spec, record.return_ids, [])
        states = []
        for rid in record.return_ids:
            state = ObjectState()
            self._objects[rid] = state
            states.append(state)
        self._enqueue_task(fresh)
        for state in states:
            await state.event.wait()
        state = self._objects.get(object_id)
        return state is not None and state.status in (INLINE, SHM)

    # ------------------------------------------------------------------
    # actor task submission (ordered, direct connection — N19 actor path)
    # ------------------------------------------------------------------
    def submit_actor_task(
        self,
        actor_id: str,
        method_name: str,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        max_task_retries: int = 0,
    ) -> list[ObjectRef]:
        task_id = self.next_task_id()
        if not args and not kwargs:
            payload, contained = serialization.EMPTY_ARGS_PAYLOAD, ()
        else:
            payload, contained = serialization.serialize((args, kwargs))
        arg_ref_ids = [r.id for r in contained]
        if arg_ref_ids:
            with self._refs_lock:
                for rid in arg_ref_ids:
                    self._submitted_refs[rid] = (
                        self._submitted_refs.get(rid, 0) + 1
                    )
        return_ids = [ObjectID.for_task_return(task_id, i) for i in range(num_returns)]
        tkey = (actor_id, method_name, num_returns, max_task_retries)
        template = self._actor_spec_templates.get(tkey)
        if template is None:
            template = self._actor_spec_templates[tkey] = {
                "task_id": "",
                "job_id": self.job_id,
                "actor_id": actor_id,
                "method": method_name,
                "name": f"{actor_id}.{method_name}",
                "args": b"",
                "num_returns": num_returns,
                "owner": {
                    "worker_id": self.worker_id,
                    "address": list(self.address),
                },
                "caller_id": self.worker_id,
                "seq": 0,  # assigned under the actor lock below
                "max_retries": max_task_retries,
                "retry_exceptions": False,
                "has_ref_args": False,
            }
        spec = dict(template)
        spec["task_id"] = task_id
        spec["args"] = payload
        spec["has_ref_args"] = bool(arg_ref_ids)
        traced = tracing.enabled()
        if traced:
            # begin/finish fast path (see submit_task): one span per actor
            # call on the submitting thread, closed right after creation —
            # the client-side cost of an actor submit is the seq+send step
            # below, which stays un-spanned to keep the actor lock short.
            submit_span = tracing.begin(
                f"submit {spec['name']}", task_id=task_id
            )
            spec["trace_ctx"] = {
                "trace_id": submit_span.trace_id,
                "span_id": submit_span.span_id,
            }
            tracing.finish(submit_span)
        record = PendingTask(spec, return_ids, arg_ref_ids)
        self._task_records[task_id] = record
        refs = []
        states = []
        for rid in return_ids:
            state = ObjectState()
            self._objects[rid] = state
            states.append(state)
            refs.append(self.new_object_ref(rid))
        # Seq assignment and the (possible) direct send are ONE atomic
        # step under the per-process actor lock: the wire then carries
        # frames in seq order — the C++ conn write queue is the ordered
        # actor queue (actor_task_submitter.cc send-in-order role).
        direct_client = None
        if (
            self._engine is not None
            and not arg_ref_ids
            and not traced
        ):
            direct_client = self._direct_actor_conn(actor_id)
        with self._actor_seq_lock:
            seq = self._actor_seq.get(actor_id, 0)
            self._actor_seq[actor_id] = seq + 1
            spec["seq"] = seq
            handle = 0
            if (
                direct_client is not None
                and self._actor_pending_slow.get(actor_id, 0) == 0
            ):
                # A pending slow send would write AFTER this frame and
                # invert program order — direct only when none are queued.
                engine = self._engine
                fl = self._fastlane
                if fl is not None:
                    ap = self._actor_spec_parts.get(tkey)
                    if ap is None:
                        ap = self._actor_spec_parts[tkey] = (
                            wire_gen.make_actor_task_spec_parts(template)
                        )
                    # One C call: splice (task_id, args), patch seq at its
                    # fixed offset, start the native call.
                    handle = fl.submit(
                        engine.handle, direct_client[0], b"push_actor_task",
                        ap[0], task_id, ap[1], payload, ap[2], seq, ap[3],
                        1 if self._direct_unsettled >= 2 else 0,
                    )
                else:
                    wire = wire_gen.encode_actor_task_spec(spec)
                    lib = (
                        engine.pylib
                        if len(wire) < engine._PYLIB_MAX_PAYLOAD
                        else engine.lib
                    )
                    starter = (
                        lib.rt_call_start_buf
                        if self._direct_unsettled >= 2
                        else lib.rt_call_start
                    )
                    handle = starter(
                        engine.handle, direct_client[0], b"push_actor_task",
                        15, wire, len(wire),
                    )
                if handle:
                    self._direct_unsettled += 1
                    # Keep the io-loop send gate in step so interleaved
                    # slow sends order correctly behind this frame.
                    gate = self._actor_send_gate.setdefault(
                        actor_id, {"next": 0, "waiters": {}}
                    )
                    gate["next"] = max(gate["next"], seq + 1)
                    if gate["waiters"]:
                        try:
                            self.io.loop.call_soon_threadsafe(
                                self._gate_release_waiters, actor_id
                            )
                        except RuntimeError:
                            pass
            if not handle:
                self._actor_pending_slow[actor_id] = (
                    self._actor_pending_slow.get(actor_id, 0) + 1
                )
        if handle:
            record.make_direct()
            record.attempts = 1
            record.native_handle = handle
            for state in states:
                state.record = record
            self._running_tasks[task_id] = direct_client[1]
            return refs
        self.io.spawn(self._run_actor_task(record))
        return refs

    def _direct_actor_conn(self, actor_id: str):
        """(conn_id, client) for an actor with a live direct connection,
        else None (first call to an actor always takes the asyncio path,
        which resolves the address and dials)."""
        addr = self._actor_addr_cache.get(actor_id)
        if addr is None:
            return None
        client = self._clients.get(tuple(addr))
        if client is None or not client.connected:
            return None
        conn_id = getattr(client, "_conn_id", None)
        if conn_id is None:
            return None
        return (conn_id, client)

    def _gate_release_waiters(self, actor_id: str) -> None:
        """io-loop: wake slow senders whose seq the direct lane passed."""
        gate = self._actor_send_gate.get(actor_id)
        if not gate:
            return
        for s, ev in list(gate["waiters"].items()):
            if s <= gate["next"]:
                ev.set()
                gate["waiters"].pop(s, None)

    async def _run_actor_task(self, record: PendingTask) -> None:
        spec = record.spec
        actor_id = spec["actor_id"]
        seq = spec["seq"]
        # In-order send gate: seq N may not write its push frame before
        # N-1 has written (or failed) — otherwise a caller racing actor
        # startup can have seq 2 observe ALIVE first and baseline the
        # receiver's expected counter past 0/1. Replies are NOT serialized:
        # the gate opens from the client's on_sent hook, so later calls
        # pipeline behind the write, not behind the round-trip.
        gate = self._actor_send_gate.setdefault(
            actor_id, {"next": 0, "waiters": {}}
        )
        while gate["next"] < seq:
            event = gate["waiters"].setdefault(seq, asyncio.Event())
            await event.wait()
        released = False

        def _release_gate() -> None:
            nonlocal released
            if released:
                return
            released = True
            gate["next"] = max(gate["next"], seq + 1)
            waiter = gate["waiters"].pop(gate["next"], None)
            if waiter is not None:
                waiter.set()
            if not record.direct:
                # Slow-path submits counted themselves in pending_slow to
                # keep the direct lane from jumping program order; the
                # frame is now on the wire (or abandoned) — release.
                with self._actor_seq_lock:
                    self._actor_pending_slow[actor_id] = max(
                        0, self._actor_pending_slow.get(actor_id, 1) - 1
                    )

        attempts = 0
        try:
            while True:
                attempts += 1
                try:
                    if record.done or spec["task_id"] in self._cancelled_tasks:
                        # cancelled while waiting for the actor to come up;
                        # cancel() already failed the returns.
                        return
                    client = await self._actor_client(actor_id)
                    self._running_tasks[spec["task_id"]] = client
                    try:
                        reply = await client.call(
                            "push_actor_task", spec, on_sent=_release_gate
                        )
                    finally:
                        self._running_tasks.pop(spec["task_id"], None)
                    if reply.get("status") == "cancelled":
                        self._fail_returns(
                            record,
                            exceptions.TaskCancelledError(
                                f"actor task {spec['name']} was cancelled"
                            ),
                        )
                        return
                    if record.done:
                        return  # cancel() finished the record while in flight
                    self._apply_reply(record, reply)
                    return
                except exceptions.ActorUnavailableError:
                    self._fail_returns(
                        record, exceptions.ActorUnavailableError(actor_id)
                    )
                    return
                except (ConnectionLost, RpcError, OSError):
                    # Actor possibly dead/restarting: consult the controller.
                    self._actor_addr_cache.pop(actor_id, None)
                    info = await self.controller.call(
                        "get_actor_info", {"actor_id": actor_id}
                    )
                    state = info.get("state")
                    # In-flight calls when an actor dies fail immediately
                    # unless max_task_retries allows a retry on the restarted
                    # incarnation (reference actor_task_submitter.cc policy).
                    if attempts <= spec["max_retries"]:
                        if state in ("RESTARTING", "PENDING", "ALIVE"):
                            await asyncio.sleep(0.2)
                            continue
                    exc: Exception
                    if state in ("RESTARTING", "PENDING"):
                        exc = exceptions.ActorUnavailableError(
                            f"actor {actor_id} is {state} during {spec['method']}"
                            " (set max_task_retries to retry across restarts)"
                        )
                    else:
                        cause = info.get("death_cause")
                        exc = exceptions.ActorDiedError(
                            f"actor {actor_id} died (state={state}"
                            + (f", cause: {cause}" if cause else "")
                            + f") during {spec['method']}"
                        )
                    self._fail_returns(record, exc)
                    return
        finally:
            # A task that never reached the wire (cancelled, actor dead,
            # address resolution failed) must still open the gate or every
            # later seq to this actor deadlocks behind it.
            _release_gate()
            # Settle the record: actor tasks bypass _finish_record (their
            # arg-ref release lives below), so without this every actor
            # call leaked a PendingTask in _task_records for the driver's
            # lifetime (observed: hundreds of undone records per module).
            record.done = True
            self._task_records.pop(spec["task_id"], None)
            self._cancelled_tasks.discard(spec["task_id"])
            if record.done_event is not None:
                record.done_event.set()
            with self._refs_lock:
                for rid in record.arg_refs:
                    count = self._submitted_refs.get(rid, 0) - 1
                    if count <= 0:
                        self._submitted_refs.pop(rid, None)
                    else:
                        self._submitted_refs[rid] = count
            for rid in record.arg_refs:
                self._maybe_free(rid)

    async def _actor_client(self, actor_id: str) -> RpcClient:
        addr = self._actor_addr_cache.get(actor_id)
        if addr is None:
            info = await self.controller.call("get_actor_info", {"actor_id": actor_id})
            deadline = time.monotonic() + global_config().actor_ready_timeout_s
            while info.get("state") in ("PENDING", "RESTARTING"):
                if time.monotonic() > deadline:
                    raise exceptions.ActorUnavailableError(
                        f"actor {actor_id} still {info.get('state')} after "
                        f"{global_config().actor_ready_timeout_s:.0f}s"
                    )
                await asyncio.sleep(0.1)
                info = await self.controller.call(
                    "get_actor_info", {"actor_id": actor_id}
                )
            if info.get("state") != "ALIVE":
                raise ConnectionLost(f"actor {actor_id} state={info.get('state')}")
            addr = tuple(info["address"])
            self._actor_addr_cache[actor_id] = addr
        return await self._client_for(addr)

    # ------------------------------------------------------------------
    # owner-protocol RPC handlers (served to other processes)
    # ------------------------------------------------------------------
    async def rpc_get_object(self, conn, payload) -> dict:
        object_id = payload["object_id"]
        state = self._objects.get(object_id)
        if state is None:
            return {"status": "failed", "error": serialization.serialize(
                exceptions.ObjectLostError(f"{object_id}: unknown to owner")
            )[0]}
        await self._await_state(state)
        if state.status == FAILED:
            return {"status": "failed", "error": state.error}
        if state.status == INLINE:
            return {"status": "inline", "data": state.data}
        return {"status": "shm", "locations": state.locations, "size": state.size}

    async def rpc_wait_object(self, conn, payload) -> dict:
        state = self._objects.get(payload["object_id"])
        if state is not None:
            await self._await_state(state)
        return {"status": "ok"}

    async def rpc_add_borrower(self, conn, payload) -> dict:
        self._borrowers.setdefault(payload["object_id"], set()).add(payload["borrower"])
        return {"status": "ok"}

    async def rpc_remove_borrower(self, conn, payload) -> dict:
        borrowers = self._borrowers.get(payload["object_id"])
        if borrowers is not None:
            borrowers.discard(payload["borrower"])
            if not borrowers:
                self._borrowers.pop(payload["object_id"], None)
                self._maybe_free(payload["object_id"])
        return {"status": "ok"}

    async def rpc_add_location(self, conn, payload) -> dict:
        state = self._objects.get(payload["object_id"])
        if state is not None:
            state.locations.append(payload["location"])
        return {"status": "ok"}

    async def rpc_ping(self, conn, payload) -> dict:
        return {"status": "ok", "worker_id": self.worker_id}


def _release_pinned(store: ObjectStoreClient, object_id: str) -> None:
    try:
        store.unpin(object_id)
    except Exception:  # rtlint: disable=swallowed-exception - unpin of an object the store may have dropped
        pass


def _encode_strategy(strategy: Any) -> dict:
    """Normalize a scheduling strategy object to a wire dict."""
    if strategy is None:
        return {}
    if isinstance(strategy, str):
        return {"kind": strategy}  # "SPREAD" | "DEFAULT"
    if isinstance(strategy, dict):
        return strategy
    # PlacementGroupSchedulingStrategy / NodeAffinitySchedulingStrategy
    kind = type(strategy).__name__
    if kind == "PlacementGroupSchedulingStrategy":
        return {
            "kind": "pg",
            "pg_id": strategy.placement_group.id,
            "bundle_index": strategy.placement_group_bundle_index,
            "capture_child_tasks": getattr(
                strategy, "placement_group_capture_child_tasks", False
            ),
        }
    if kind == "NodeAffinitySchedulingStrategy":
        return {"kind": "node_affinity", "node_id": strategy.node_id, "soft": strategy.soft}
    raise ValueError(f"unknown scheduling strategy: {strategy!r}")
