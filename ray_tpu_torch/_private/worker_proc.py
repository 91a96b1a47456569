"""Worker process — executes tasks and hosts actors.

Role-equivalent of the reference's worker side of the core worker:
task_receiver.cc / actor_scheduling_queue.cc / concurrency_group_manager.cc
[N20] plus the Python execution callback in _raylet.pyx [N30].

Execution runs on dedicated executor threads (the RPC loop stays free),
actor calls are ordered per caller by sequence number, and async actor
methods run on a separate asyncio loop (the reference's async-actor fibers).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import inspect
import json
import os
import sys
import queue
import threading
import time as _time
import traceback
from typing import Any

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import global_config
from ray_tpu_torch.util import tracing
from ray_tpu_torch._private.core_context import CoreContext
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.rpc import RpcClient


def _peak_rss_bytes() -> int:
    """Process high-water RSS via getrusage — ~1µs, cheap enough for the
    per-task attribution hot path (a psutil read here would dominate a
    no-op task and blow the telemetry overhead budget). Linux reports
    ru_maxrss in KiB; macOS in bytes."""
    try:
        import resource as _resource

        peak = _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:  # rtlint: disable=swallowed-exception - no resource module (non-posix): report zero
        return 0


class WorkerRuntime:
    def __init__(self) -> None:
        self.ctx = CoreContext(
            job_id=os.environ["RAYTPU_JOB_ID"],
            node_id=os.environ["RAYTPU_NODE_ID"],
            controller_addr=tuple(json.loads(os.environ["RAYTPU_CONTROLLER"])),
            agent_addr=tuple(json.loads(os.environ["RAYTPU_AGENT"])),
            store_info=json.loads(os.environ["RAYTPU_STORE"]),
            is_driver=False,
            worker_id=os.environ["RAYTPU_WORKER_ID"],
        )
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="exec"
        )
        self._async_loop: asyncio.AbstractEventLoop | None = None
        self._async_sem: "asyncio.Semaphore | None" = None
        self._actor_concurrency = 1
        self.actor_instance: Any = None
        self.actor_spec: dict | None = None
        # per-caller ordered queues (actor_scheduling_queue.cc)
        self._order: dict[str, dict] = {}
        self._fn_cache: dict[str, Any] = {}
        self._task_event_lock = threading.Lock()
        # Cancellation state (reference: task_receiver.cc cancel path +
        # the ray.cancel KeyboardInterrupt convention). Normal tasks run on
        # the MAIN thread so SIGINT interrupts even blocking C calls
        # (time.sleep etc.) — exactly how the reference worker does it;
        # executor threads (sync actor tasks) get best-effort async-exc.
        self._running_exec: dict = {}      # task_id -> thread ident
        self._running_async: dict = {}     # task_id -> coroutine future
        self._cancelled_pending: set = set()
        self._main_work: "queue.Queue" = queue.Queue()
        self._main_ident: int | None = None
        self._main_executing = False
        self._main_current_task: str | None = None
        self._cancel_target: str | None = None
        self._task_events_last_flush = 0.0
        # compiled-graph state: dag_id → resident rtdag runtime (stage
        # loops + channels + per-dag device group), dag/executor.py
        self._dag_runtimes: dict = {}
        # Fast execution lane (native exec queue, task_receiver.cc role):
        # push_task/push_actor_task frames bypass asyncio; the main thread
        # consumes them via rt_exec_next. Ineligible frames bounce back to
        # the asyncio handlers.
        self._engine = None
        self._fast_mode = False
        self._inject_lock = threading.Lock()
        self._next_inject = 1
        self._main_injected: dict[int, tuple] = {}
        self._bounced_actor = 0
        # guards _bounced_actor: incremented on the exec thread,
        # decremented on the io loop — bare += would lose updates and
        # either run two tasks on a max_concurrency=1 actor or wedge the
        # fast lane shut.
        self._bounce_lock = threading.Lock()
        # per-callable coroutine-ness (inspect.iscoroutinefunction costs
        # ~3us per call; keyed by __func__ so bound methods hit)
        self._coro_cache: dict = {}
        self._method_cache: dict[str, Any] = {}
        # Per-task resource attribution: tri-state card probe —
        # None = unknown yet, False = no card leased (never probe again),
        # True = card live (read its memory around every task).
        self._hbm_probe: bool | None = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        ctx = self.ctx
        for method in (
            "push_task", "push_actor_task", "create_actor", "exit",
            "cancel_task", "dag_register", "dag_push", "dag_pop",
            "dag_teardown", "dag_snapshot", "dag_restore",
            "profiler", "stack_trace", "engine_debug", "comm_flight",
        ):
            ctx.core_server.route(method, getattr(self, f"rpc_{method}"))
        ctx.connect()
        if ctx._engine is not None:
            # Divert the task-push methods into the native exec queue —
            # they never touch the asyncio inbox (the reference's
            # task_receiver fast path). Everything else (cancel, stacks,
            # dag, create_actor, exit) stays on the asyncio server.
            self._engine = ctx._engine
            self._engine.lib.rt_exec_filter(self._engine.handle, b"push_task")
            self._engine.lib.rt_exec_filter(
                self._engine.handle, b"push_actor_task"
            )
            self._fast_mode = True
        # Make the global API (ray_tpu_torch.get/put/remote...) work inside tasks.
        from ray_tpu_torch._private import worker as worker_mod

        worker_mod.set_global_context(ctx, is_driver=False)
        ctx.io.run(self._register_with_agent())

    async def _register_with_agent(self) -> None:
        await self.ctx.agent.call(
            "register_worker",
            {"worker_id": self.ctx.worker_id, "address": list(self.ctx.address)},
        )

    def run_main_loop(self) -> None:
        """Main-thread task execution loop. Normal tasks run here so that
        a cancellation SIGINT raises KeyboardInterrupt inside whatever the
        task is doing — including blocking C calls."""
        import signal as _signal

        self._main_ident = threading.get_ident()
        _signal.signal(_signal.SIGINT, self._on_sigint)
        if self._fast_mode:
            self._run_fast_main_loop()
            return
        while True:
            fn, fut = self._main_work.get()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as exc:  # noqa: BLE001 - ferry to waiter
                fut.set_exception(exc)

    def _run_fast_main_loop(self) -> None:
        from ray_tpu_torch import _native

        fl = _native.load_fastlane()
        if fl is not None:
            self._run_fastlane_loop(fl)
        else:
            self._run_ctypes_fast_loop()

    def _run_fastlane_loop(self, fl) -> None:
        """Native fast lane (the task_receiver.cc role done properly):
        the _fastlane C extension decodes push frames, classifies
        eligibility, and encodes+sends replies — one C call in, one C
        call out per task. Python keeps pickle + the user function.
        Anything the extension can't prove simple arrives as a bounce
        tuple and takes the asyncio path unchanged."""
        engine = self._engine
        eng = engine.handle
        ObjectRefT = ObjectRef
        fn_cache = self._fn_cache
        while True:
            item = fl.exec_next(eng, 1000)
            if item is None:
                continue
            tag = item[0]
            if tag == 1:  # plain task, pre-decoded
                (_, conn, msgid, task_id, function_id, name, args_raw,
                 num_returns, raw) = item
                try:
                    fn = fn_cache.get(function_id)
                    if fn is None:
                        self._bounce_raw(conn, msgid, b"push_task", raw)
                        continue
                    args, kwargs = self._deserialize_args(args_raw)
                    if any(isinstance(a, ObjectRefT) for a in args) or any(
                        isinstance(v, ObjectRefT) for v in kwargs.values()
                    ):
                        self._bounce_raw(conn, msgid, b"push_task", raw)
                        continue
                    spec = {
                        "task_id": task_id,
                        "name": name,
                        "num_returns": num_returns,
                    }
                    reply = self._execute(spec, fn, False, (args, kwargs))
                except Exception:
                    payload, _ = serialization.serialize(
                        exceptions.TaskError(name, traceback.format_exc())
                    )
                    reply = {"status": "error", "error": payload}
                self._send_fast_reply(
                    fl, eng, conn, msgid, b"push_task", reply
                )
                continue
            if tag == 2:  # actor task, pre-decoded
                (_, conn, msgid, task_id, method_name, name, caller_id,
                 args_raw, num_returns, seq, raw) = item
                state = self._order.get(caller_id)
                if state is None:
                    state = self._order[caller_id] = {
                        "expected": seq, "waiters": {},
                    }
                state["expected"] = max(state["expected"], seq + 1)
                try:
                    if (
                        self.actor_instance is None
                        or method_name == "__ray_terminate__"
                        or self._actor_concurrency > 1
                        or self._bounced_actor > 0
                    ):
                        self._bounce_raw(
                            conn, msgid, b"push_actor_task", raw
                        )
                        continue
                    bound = self._method_cache.get(method_name)
                    if bound is None:
                        bound = getattr(
                            self.actor_instance, method_name, None
                        )
                        if bound is None:
                            payload, _ = serialization.serialize(
                                AttributeError(
                                    f"actor has no method {method_name!r}"
                                )
                            )
                            self._send_fast_reply(
                                fl, eng, conn, msgid, b"push_actor_task",
                                {"status": "error", "error": payload},
                            )
                            continue
                        self._method_cache[method_name] = bound
                    fn_key = getattr(bound, "__func__", bound)
                    is_coro = self._coro_cache.get(fn_key)
                    if is_coro is None:
                        is_coro = inspect.iscoroutinefunction(bound)
                        self._coro_cache[fn_key] = is_coro
                    if is_coro:
                        self._bounce_raw(
                            conn, msgid, b"push_actor_task", raw
                        )
                        continue
                    args, kwargs = self._deserialize_args(args_raw)
                    if any(isinstance(a, ObjectRefT) for a in args) or any(
                        isinstance(v, ObjectRefT) for v in kwargs.values()
                    ):
                        self._bounce_raw(
                            conn, msgid, b"push_actor_task", raw
                        )
                        continue
                    spec = {
                        "task_id": task_id,
                        "name": name,
                        "num_returns": num_returns,
                    }
                    reply = self._execute(spec, bound, True, (args, kwargs))
                except Exception:
                    payload, _ = serialization.serialize(
                        exceptions.TaskError(name, traceback.format_exc())
                    )
                    reply = {"status": "error", "error": payload}
                self._send_fast_reply(
                    fl, eng, conn, msgid, b"push_actor_task", reply
                )
                continue
            if tag == 0:  # injected Python work item
                pair = self._main_injected.pop(item[1], None)
                if pair is None:
                    continue
                fn, fut = pair
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn())
                except BaseException as exc:  # noqa: BLE001
                    fut.set_exception(exc)
                continue
            if tag == 4:  # engine stopping
                return
            # tag == 3: ineligible frame — full Python decode + asyncio.
            # A frame even the full codec cannot decode must reply with a
            # TaskError, not kill this thread (a dead fast lane hangs
            # every subsequent task with no reply).
            _, conn, msgid, method, payload = item
            try:
                self._bounce_raw(conn, msgid, method, payload)
            except Exception:
                err, _ = serialization.serialize(
                    exceptions.TaskError(
                        method.decode("utf-8", "replace"),
                        traceback.format_exc(),
                    )
                )
                self._send_fast_reply(
                    fl, eng, conn, msgid, method,
                    {"status": "error", "error": err},
                )

    def _bounce_raw(self, conn, msgid, method, payload) -> None:
        """Decode a raw frame with the full typed codec and hand it to
        the asyncio handler (the fastlane twin of the ctypes loop's
        inline bounce decisions)."""
        from ray_tpu_torch._private import wire_gen

        if method == b"push_task":
            spec = wire_gen.decode_task_spec(payload)
            self._bounce(conn, msgid, method, "push_task", spec)
        else:
            spec = wire_gen.decode_actor_task_spec(payload)
            caller = spec.get("caller_id", "?")
            seq = spec.get("seq", 0)
            state = self._order.get(caller)
            if state is None:
                state = self._order[caller] = {
                    "expected": seq, "waiters": {},
                }
            state["expected"] = max(state["expected"], seq + 1)
            self._bounce(conn, msgid, method, "push_actor_task", spec,
                         actor=True)

    def _send_fast_reply(
        self, fl, eng, conn, msgid, method, reply
    ) -> None:
        from ray_tpu_torch._private import wire_gen

        if reply is None:
            return
        if reply.get("status") == "ok":
            rets = reply.get("returns")
            if (
                rets is not None
                and len(rets) == 1
                and rets[0].get("kind") == "inline"
            ):
                fl.reply_inline(eng, conn, msgid, method, rets[0]["data"])
                return
        fl.reply_raw(
            eng, conn, msgid, method, wire_gen.encode_task_reply(reply)
        )

    def _run_ctypes_fast_loop(self) -> None:
        """Fast-lane twin of the loop above: consumes the native exec
        queue (diverted push frames + injected io-loop work) in arrival
        order. Decode via the typed wire schema, execute, reply — all on
        this thread; the asyncio loop is only involved for bounced frames.
        (Fallback when the _fastlane extension is unavailable.)
        """
        import ctypes

        from ray_tpu_torch import _native
        from ray_tpu_torch._private import wire_gen
        from ray_tpu_torch._private.rpc import REP

        engine = self._engine
        lib = _native.load()  # CDLL: rt_exec_next blocks with GIL released
        view = _native.RtMsgView()
        while True:
            rc = lib.rt_exec_next(engine.handle, 1000, ctypes.byref(view))
            if rc == 0:
                continue
            if rc == -1:
                return  # engine stopped: process is shutting down
            if view.kind == 253:  # injected Python work item
                tag = view.msgid
                lib.rt_msg_free(view.opaque)
                pair = self._main_injected.pop(tag, None)
                if pair is None:
                    continue
                fn, fut = pair
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn())
                except BaseException as exc:  # noqa: BLE001
                    fut.set_exception(exc)
                continue
            conn = view.conn
            msgid = view.msgid
            method = (
                ctypes.string_at(view.method, view.mlen) if view.mlen else b""
            )
            raw = (
                ctypes.string_at(view.payload, view.plen) if view.plen else b""
            )
            lib.rt_msg_free(view.opaque)
            try:
                if method == b"push_task":
                    reply = self._fast_push_task(conn, msgid, method, raw)
                else:
                    reply = self._fast_push_actor_task(
                        conn, msgid, method, raw
                    )
            except Exception:
                payload, _ = serialization.serialize(
                    exceptions.TaskError("fast-lane", traceback.format_exc())
                )
                reply = {"status": "error", "error": payload}
            if reply is not None:
                out = wire_gen.encode_task_reply(reply)
                if engine.pylib.rt_exec_pending(engine.handle) > 0:
                    # More work queued: buffer the reply for the engine
                    # thread's coalesced writev instead of paying an
                    # inline syscall (+ scheduler preemption) per task.
                    engine.pylib.rt_send_buf(
                        engine.handle, conn, REP, msgid,
                        method, len(method), out, len(out),
                    )
                else:
                    engine.send(conn, REP, msgid, method, out)

    def _fast_push_task(self, conn, msgid, method, raw):
        """Execute a push_task frame on this thread, or bounce it to the
        asyncio handler (cross-language, cold function cache, ref args —
        dependency resolution must never block the main lane: a pipelined
        upstream task could be queued right behind us)."""
        from ray_tpu_torch._private import wire_gen

        spec = wire_gen.decode_task_spec(raw)
        if spec.get("cross_language") or spec.get("has_ref_args"):
            # has_ref_args: the submitter's hint skips deserializing a
            # payload we would bounce anyway (the scan below still guards
            # against third-party clients that omit the hint).
            self._bounce(conn, msgid, method, "push_task", spec)
            return None
        fn = self._fn_cache.get(spec["function_id"])
        if fn is None:
            self._bounce(conn, msgid, method, "push_task", spec)
            return None
        args, kwargs = self._deserialize_args(spec["args"])
        if any(isinstance(a, ObjectRef) for a in args) or any(
            isinstance(v, ObjectRef) for v in kwargs.values()
        ):
            self._bounce(conn, msgid, method, "push_task", spec)
            return None
        return self._execute(spec, fn, False, (args, kwargs))

    def _fast_push_actor_task(self, conn, msgid, method, raw):
        """Execute an actor call on this thread when the actor is a plain
        sync max_concurrency=1 actor; otherwise bounce. Frames arrive
        per-conn FIFO and submitters write in seq order, so arrival order
        IS seq order (the C++ conn queue is the ordered actor queue); a
        gap only appears when an earlier submission died with a previous
        incarnation — baseline forward like the asyncio path does."""
        from ray_tpu_torch._private import wire_gen

        spec = wire_gen.decode_actor_task_spec(raw)
        caller = spec.get("caller_id", "?")
        seq = spec.get("seq", 0)
        state = self._order.get(caller)
        if state is None:
            state = self._order[caller] = {"expected": seq, "waiters": {}}
        state["expected"] = max(state["expected"], seq + 1)
        method_name = spec["method"]
        if (
            self.actor_instance is None
            or method_name == "__ray_terminate__"
            or self._actor_concurrency > 1
            or self._bounced_actor > 0
            or spec.get("has_ref_args")
        ):
            self._bounce(conn, msgid, method, "push_actor_task", spec,
                         actor=True)
            return None
        bound = self._method_cache.get(method_name)
        if bound is None:
            bound = getattr(self.actor_instance, method_name, None)
            if bound is None:
                payload, _ = serialization.serialize(
                    AttributeError(f"actor has no method {method_name!r}")
                )
                return {"status": "error", "error": payload}
            self._method_cache[method_name] = bound
        fn_key = getattr(bound, "__func__", bound)
        is_coro = self._coro_cache.get(fn_key)
        if is_coro is None:
            is_coro = inspect.iscoroutinefunction(bound)
            self._coro_cache[fn_key] = is_coro
        if is_coro:
            self._bounce(conn, msgid, method, "push_actor_task", spec,
                         actor=True)
            return None
        args, kwargs = self._deserialize_args(spec["args"])
        if any(isinstance(a, ObjectRef) for a in args) or any(
            isinstance(v, ObjectRef) for v in kwargs.values()
        ):
            self._bounce(conn, msgid, method, "push_actor_task", spec,
                         actor=True)
            return None
        return self._execute(spec, bound, True, (args, kwargs))

    def _bounce(self, conn, msgid, method, handler_name, spec, actor=False):
        """Hand a frame the fast lane must not run to the asyncio handler;
        the reply is sent from the io loop. While a bounced actor task is
        outstanding, later actor frames bounce too so a max_concurrency=1
        actor never runs two tasks at once."""
        from ray_tpu_torch._private import wire_gen
        from ray_tpu_torch._private.rpc import REP, spawn_task

        if actor:
            with self._bounce_lock:
                self._bounced_actor += 1
        handler = getattr(self, f"rpc_{handler_name}")
        engine = self._engine

        async def run():
            try:
                try:
                    reply = await handler(None, spec)
                except Exception:
                    payload, _ = serialization.serialize(
                        exceptions.TaskError(
                            spec.get("name", "task"), traceback.format_exc()
                        )
                    )
                    reply = {"status": "error", "error": payload}
                try:
                    engine.send(
                        conn, REP, msgid, method,
                        wire_gen.encode_task_reply(reply),
                    )
                except Exception:  # rtlint: disable=swallowed-exception - conn died: nothing more to tell the peer
                    pass  # conn died: nothing more to tell the peer
            finally:
                if actor:
                    with self._bounce_lock:
                        self._bounced_actor -= 1

        self.ctx.io.loop.call_soon_threadsafe(spawn_task, run())

    def _on_sigint(self, signum, frame) -> None:
        # Only deliver while the TARGETED task is executing: a SIGINT that
        # lands after the target finished (and another task started) must
        # not cancel the wrong task — nor kill the idle worker loop.
        if (
            self._main_executing
            and self._cancel_target is not None
            and self._main_current_task == self._cancel_target
        ):
            self._cancel_target = None
            raise KeyboardInterrupt

    async def _run_on_main(self, fn) -> dict:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self._fast_mode:
            with self._inject_lock:
                tag = self._next_inject
                self._next_inject = (self._next_inject % 0xFFFFFFF0) + 1
                self._main_injected[tag] = (fn, fut)
            self._engine.pylib.rt_exec_inject(self._engine.handle, tag)
        else:
            self._main_work.put((fn, fut))
        return await asyncio.wrap_future(fut)

    def _async_exec_loop(self) -> asyncio.AbstractEventLoop:
        if self._async_loop is None:
            loop = asyncio.new_event_loop()
            thread = threading.Thread(
                target=loop.run_forever, name="actor-async", daemon=True
            )
            thread.start()
            self._async_loop = loop
        return self._async_loop

    # ------------------------------------------------------------------
    # function / class resolution via the controller KV (function table)
    # ------------------------------------------------------------------
    async def _load_callable(self, function_id: str) -> Any:
        """Fetch+cache from the controller KV function table. Runs on the io
        loop (must not block it with sync ctx calls)."""
        cached = self._fn_cache.get(function_id)
        if cached is not None:
            return cached
        # Brief retry: the owner's kv_put may still be in flight when the
        # first task referencing the function reaches a fresh worker.
        for attempt in range(10):
            resp = await self.ctx.controller.call(
                "kv_get", {"namespace": "funcs", "key": function_id}
            )
            if resp["status"] == "ok":
                break
            await asyncio.sleep(0.2)
        if resp["status"] != "ok":
            raise RuntimeError(f"function {function_id} not found in function table")
        # Functions/classes may close over ObjectRefs — resolve them the
        # same way task args do (register the borrow with the owner).
        def resolver(ref_id, owner_address):
            ref = ObjectRef(ref_id, owner_address, runtime=self.ctx)
            self.ctx._note_borrow(ref_id, owner_address)
            return ref

        fn = serialization.loads_function(resp["value"], ref_resolver=resolver)
        self._fn_cache[function_id] = fn
        return fn

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _deserialize_args(self, payload) -> tuple[tuple, dict]:
        """Deserialize an args payload, registering borrows for contained
        ObjectRefs (shared by the sync and async resolution paths)."""
        def resolver(ref_id, owner_address):
            ref = ObjectRef(ref_id, owner_address, runtime=self.ctx)
            self.ctx._note_borrow(ref_id, owner_address)
            return ref

        return serialization.deserialize(payload, resolver, zero_copy=False)

    def _resolve_args(self, payload) -> tuple[tuple, dict]:
        args, kwargs = self._deserialize_args(payload)
        # Top-level ObjectRef args are resolved to values before invocation
        # (reference semantics; nested refs stay refs).
        args = tuple(
            self.ctx.get(a) if isinstance(a, ObjectRef) else a for a in args
        )
        kwargs = {
            k: self.ctx.get(v) if isinstance(v, ObjectRef) else v
            for k, v in kwargs.items()
        }
        return args, kwargs

    def _package_returns(self, spec: dict, values: list[Any]) -> list[dict]:
        cfg = global_config()
        out = []
        for index, value in enumerate(values):
            if value is None:
                out.append(
                    {"kind": "inline", "data": serialization.NONE_PAYLOAD}
                )
                continue
            payload, _ = serialization.serialize(value)
            if len(payload) <= cfg.max_direct_call_object_size:
                out.append({"kind": "inline", "data": payload})
            else:
                object_id = f"obj-{spec['task_id']}-r{index}"
                try:
                    self.ctx.store.put(object_id, payload)
                except FileExistsError:
                    pass
                out.append(
                    {
                        "kind": "shm",
                        "size": len(payload),
                        "location": self.ctx._local_location(),
                    }
                )
        return out

    def _execute(
        self,
        spec: dict,
        fn: Any,
        is_method: bool,
        preresolved: tuple | None = None,
    ) -> dict:
        name = spec.get("name", "task")
        task_id = spec.get("task_id")
        if task_id in self._cancelled_pending:
            # Cancelled while queued at this worker (e.g. behind an actor's
            # ordered/concurrency queue).
            self._cancelled_pending.discard(task_id)
            self._record_task_event(spec, "CANCELLED")
            return {"status": "cancelled"}
        # RUNNING is recorded eagerly — a hung task must be visible to the
        # state API while stuck; the terminal record additionally carries
        # start_ts so one record describes the whole span.
        start_ts = _time.time()
        self._record_task_event(spec, "RUNNING")
        on_main = threading.get_ident() == self._main_ident
        self._running_exec[task_id] = threading.get_ident()
        if on_main:
            self._main_current_task = task_id
            self._main_executing = True
        trace_ctx = spec.get("trace_ctx") if tracing.enabled() else None
        arrival_ns = spec.pop("_arrival_ns", None)
        if trace_ctx and arrival_ns:
            # In-actor queue wait: time between the call frame arriving at
            # this worker and the method actually starting.
            tracing.emit(
                "queue_wait", trace_ctx, start_ns=arrival_ns,
                task_id=task_id, worker_id=self.ctx.worker_id,
            )
        if trace_ctx is None:
            return self._execute_inner(
                spec, fn, preresolved, name, task_id, on_main, start_ts
            )
        # begin/finish fast path + explicit contextvar write: user code
        # runs inside, so nested .remote() calls must see this span as
        # the ambient parent (what span() would have provided), but the
        # contextmanager machinery is per-task overhead.
        tspan = tracing.begin(
            f"execute {name}", parent=trace_ctx,
            task_id=task_id, worker_id=self.ctx.worker_id,
        )
        token = tracing.set_current(tspan)
        try:
            return self._execute_inner(
                spec, fn, preresolved, name, task_id, on_main, start_ts,
                trace_span=tspan,
            )
        except BaseException as exc:
            tspan.set_error(exc)
            raise
        finally:
            tracing.reset_current(token)
            tracing.finish(tspan)

    def _execute_inner(
        self, spec, fn, preresolved, name, task_id, on_main, start_ts=None,
        trace_span=None,
    ) -> dict:
        rss0 = _peak_rss_bytes()
        hbm0 = self._hbm_used()
        try:
            if preresolved is not None:
                args, kwargs = preresolved
            elif trace_span is not None and spec.get("has_ref_args"):
                # fetch_args times DEPENDENCY resolution; inline-only args
                # resolve in-place, so the span would only add per-task
                # overhead without information.
                with tracing.span(
                    "fetch_args", parent=spec.get("trace_ctx"),
                    task_id=task_id,
                ):
                    args, kwargs = self._resolve_args(spec["args"])
            else:
                args, kwargs = self._resolve_args(spec["args"])
            fn_key = getattr(fn, "__func__", fn)
            is_coro = self._coro_cache.get(fn_key)
            if is_coro is None:
                is_coro = inspect.iscoroutinefunction(fn)
                self._coro_cache[fn_key] = is_coro
            if is_coro:
                loop = self._async_exec_loop()
                cfut = asyncio.run_coroutine_threadsafe(
                    fn(*args, **kwargs), loop
                )
                self._running_async[task_id] = cfut
                try:
                    value = cfut.result()
                finally:
                    self._running_async.pop(task_id, None)
            else:
                value = fn(*args, **kwargs)
            num_returns = spec.get("num_returns", 1)
            values = [value] if num_returns == 1 else list(value)
            self._record_task_event(
                spec, "FINISHED", start_ts,
                self._task_resources(rss0, hbm0, trace_span),
            )
            if trace_span is not None:
                # begin/finish fast path: parent is explicit and no user
                # code runs inside, so the contextvar write of span() is
                # pure per-task overhead here.
                pspan = tracing.begin(
                    "put_result", parent=spec.get("trace_ctx"),
                    task_id=task_id, num_returns=num_returns,
                )
                try:
                    returns = self._package_returns(spec, values)
                finally:
                    tracing.finish(pspan)
            else:
                returns = self._package_returns(spec, values)
            return {"status": "ok", "returns": returns}
        except (KeyboardInterrupt, concurrent.futures.CancelledError,
                asyncio.CancelledError):
            # KeyboardInterrupt: raised by rpc_cancel_task via SIGINT /
            # async-exc (ray.cancel convention — the task sees it).
            # CancelledError: an async task's coroutine was cancelled.
            if trace_span is not None:
                trace_span.status = "cancelled"
            self._record_task_event(spec, "CANCELLED", start_ts)
            return {"status": "cancelled"}
        except Exception as exc:
            if trace_span is not None:
                trace_span.set_error(exc)
            self._record_task_event(
                spec, "FAILED", start_ts,
                self._task_resources(rss0, hbm0, trace_span),
            )
            err = exceptions.TaskError(name, traceback.format_exc())
            payload, _ = serialization.serialize(err)
            return {"status": "error", "error": payload}
        finally:
            if on_main:
                self._main_executing = False
                self._main_current_task = None
            self._running_exec.pop(task_id, None)

    def _hbm_used(self) -> int | None:
        """Card memory this process has allocated through torch, summed
        over its visible cards, or None when it drives no card. Never
        initialises CUDA: only a process whose user code already did is
        read. The probe is tri-state cached: a worker leased no card
        (``CUDA_VISIBLE_DEVICES`` empty) is a single attribute check per
        task forever after."""
        if self._hbm_probe is False:
            return None
        if os.environ.get("CUDA_VISIBLE_DEVICES") == "":
            self._hbm_probe = False
            return None
        mod = sys.modules.get("torch")
        if mod is None:
            return None
        try:
            if not mod.cuda.is_initialized():
                return None
            self._hbm_probe = True
            return sum(
                int(mod.cuda.memory_allocated(i))
                for i in range(mod.cuda.device_count())
            )
        except Exception:
            self._hbm_probe = False
            return None

    def _task_resources(
        self, rss0: int, hbm0: int | None, trace_span=None
    ) -> dict:
        """Per-task resource attribution. ru_maxrss is a process
        high-water mark, so ``rss_delta`` is how much THIS task raised it —
        the "which task ate the memory" signal — and ``peak_rss`` is the
        worker's peak during/before the task. Also stamped into the
        execute span so traces carry the memory story alongside latency."""
        peak = _peak_rss_bytes()
        res = {"peak_rss": peak, "rss_delta": max(0, peak - rss0)}
        if hbm0 is not None:
            hbm1 = self._hbm_used()
            if hbm1 is not None:
                res["hbm_delta"] = hbm1 - hbm0
        if trace_span is not None:
            trace_span.attributes.update(res)
        return res

    def _record_task_event(
        self, spec: dict, state: str, start_ts: float | None = None,
        resources: dict | None = None,
    ) -> None:
        """Task lifecycle events feed the state API + `ray_tpu_torch timeline`
        (reference: profile_event.cc → gcs_task_manager.cc [N5]). Terminal
        events carry ``start_ts`` so one record describes the whole span,
        plus the per-task resource attribution when measured."""
        with self._task_event_lock:
            # Hot path appends a tuple; the flush below expands it into the
            # full record (the reference buffers a ring of slim events and
            # reports periodically, gcs_task_manager) — building an 8-key
            # dict per lifecycle event costs more than the task envelope.
            self.ctx._task_events.append(
                (spec.get("task_id"), spec.get("name"), state, start_ts,
                 _time.time(), resources)
            )
            # Batch: size- or time-triggered, never per-event.
            now = _time.monotonic()
            due = (
                len(self.ctx._task_events) >= 100
                or now - self._task_events_last_flush > 1.0
            )
            if not due:
                return
            slim = self.ctx._task_events[:]
            self.ctx._task_events.clear()
            self._task_events_last_flush = now
        node_id = self.ctx.node_id
        worker_id = self.ctx.worker_id
        pid = os.getpid()
        events = []
        for task_id, name, ev_state, ev_start, ts, extras in slim:
            event = {
                "task_id": task_id,
                "name": name,
                "state": ev_state,
                "node_id": node_id,
                "worker_id": worker_id,
                "pid": pid,
                "ts": ts,
            }
            if ev_start is not None:
                event["start_ts"] = ev_start
            if extras:
                event.update(extras)  # peak_rss / rss_delta / hbm_delta
            events.append(event)

        async def _flush():
            try:
                await self.ctx.controller.call(
                    "report_task_events", {"events": events}
                )
            except Exception:  # rtlint: disable=swallowed-exception - task-event uplink is advisory telemetry
                pass

        self.ctx.io.spawn(_flush())

    # ------------------------------------------------------------------
    # RPC handlers
    # ------------------------------------------------------------------
    def _collect_stacks(self) -> tuple[dict, dict]:
        """(thread stacks, parked asyncio task stacks) — native frame
        walk, no external deps."""
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        stacks = {}
        for ident, frame in frames.items():
            label = f"{names.get(ident, 'unknown')}-{ident}"
            stacks[label] = "".join(traceback.format_stack(frame))
        # Parked coroutines are invisible in thread frames — dump the io
        # loop's asyncio tasks too (where a wedged RPC handler actually is).
        coros = {}
        try:
            for task in asyncio.all_tasks():
                tb = task.get_stack(limit=6)
                coros[task.get_name()] = [
                    f"{f.f_code.co_filename}:{f.f_lineno} {f.f_code.co_name}"
                    for f in tb
                ]
        except Exception:  # rtlint: disable=swallowed-exception - stack introspection is advisory debug info
            pass
        return stacks, coros

    async def rpc_stack_trace(self, conn, payload) -> dict:
        """Live stack dump of every thread in this worker (the reference's
        dashboard 'Stack Trace' button shells out to py-spy on the worker
        pid — reporter_agent.py; in-process frames need no subprocess)."""
        stacks, coros = self._collect_stacks()
        return {
            "status": "ok",
            "pid": os.getpid(),
            "worker_id": self.ctx.worker_id,
            "current_task": self._main_current_task,
            "stacks": stacks,
            "asyncio_tasks": coros,
        }

    async def rpc_comm_flight(self, conn, payload) -> dict:
        """Hang-doctor evidence: this worker's last-N comm flight records,
        in-flight summary, local stall events, and a native stack dump —
        one round trip per rank during a cluster-wide harvest."""
        from ray_tpu_torch.util.collective import flight

        last_n = int((payload or {}).get("last_n", 256))
        with_stacks = bool((payload or {}).get("stacks", True))
        out = {
            "status": "ok",
            "pid": os.getpid(),
            "worker_id": self.ctx.worker_id,
            "current_task": self._main_current_task,
            "records": flight.snapshot(last_n),
            "inflight": flight.inflight_summary(),
            "stalls": flight.stall_events(),
        }
        if with_stacks:
            stacks, coros = self._collect_stacks()
            out["stacks"] = stacks
            out["asyncio_tasks"] = coros
        return out

    async def rpc_engine_debug(self, conn, payload) -> dict:
        """Native transport state of every conn this worker's engine owns
        (hang forensics: wq/rbuf levels reveal lost-frame desyncs)."""
        import ctypes

        from ray_tpu_torch._private.rpc import _NativeEngine

        try:
            engine = _NativeEngine.for_running_loop()
        except Exception as exc:
            return {"status": "error", "error": str(exc)}
        ids = (ctypes.c_longlong * 256)()
        n = engine.lib.rt_list_conns(engine.handle, ids, 256)
        conns = {}
        for i in range(n):
            out = (ctypes.c_longlong * 6)()
            if engine.lib.rt_conn_debug(engine.handle, ids[i], out) == 0:
                conns[int(ids[i])] = {
                    "wq_len": out[0], "woff": out[1], "fd": out[2],
                    "closed": out[3], "bytes_queued": out[4],
                    "unparsed_rbuf": out[5],
                }
        return {"status": "ok", "pid": os.getpid(), "conns": conns,
                "owners": {c: type(o).__name__
                           for c, o in engine.owners.items()}}

    async def rpc_profiler(self, conn, payload) -> dict:
        """Profiler control surface.

        Manual actions (the original SURVEY §5.1 hook, hardened):
        ``start``/``stop`` drive a raw torch.profiler trace into a
        session-dir directory. Errors are TYPED (``code`` field):
        double-start → ``already_started``, stop-without-start →
        ``not_started``, a live coordinated capture → ``plane_active``.
        Output dirs are GC'd on every start (session-scoped TTL,
        RAY_TPU_PROFILE_DIR_TTL_S — they used to accumulate forever).

        Coordinated actions (the cluster step profiler):
        ``arm``/``status``/``collect``/``abort`` delegate to this
        worker's :class:`~ray_tpu_torch._private.profiler.ProfilePlane` —
        step-boundary-aligned capture of device trace + host sampling
        profiler + annotation slices, harvested by the controller."""
        from ray_tpu_torch._private import profiler as profiler_mod

        action = payload.get("action")
        plane = profiler_mod.get_plane()
        if action == "arm":
            plane.set_meta(worker_id=self.ctx.worker_id)
            return await asyncio.to_thread(plane.arm, payload)
        if action == "status":
            return plane.status()
        if action == "collect":
            return plane.collect()
        if action == "abort":
            return await asyncio.to_thread(plane.abort)
        if action == "start":
            # The port's plane keeps the manual trace (torch.profiler, on
            # the card unless ``device`` says otherwise) and its typed
            # errors; this loop's thread starts and stops it, so owns it.
            base = profiler_mod.profiles_base_dir()
            log_dir = payload.get("log_dir") or os.path.join(
                base, f"worker-{self.ctx.worker_id[-12:]}"
            )
            return profiler_mod.start_trace(log_dir, payload.get("device"))
        if action == "stop":
            return profiler_mod.stop_trace()
        return {"status": "error", "code": "unknown_action",
                "error": f"unknown action {action!r}"}

    async def rpc_push_task(self, conn, spec) -> dict:
        if spec.get("cross_language"):
            # Cross-language call (C++ worker API, reference N32 role /
            # Ray's Java→Python convention): the function is named by a
            # module-qualified ref ("pkg.module:attr"), args are plain
            # msgpack values, and returns go back inline as msgpack so a
            # non-Python caller can decode them.
            return await self._run_cross_language(spec)
        fn = await self._load_callable(spec["function_id"])
        # Resolve argument dependencies on the io loop BEFORE taking the
        # main execution lane (reference: dependency resolution precedes
        # execution — dependency_resolver.cc / raylet arg gating). With
        # pipelined pushes, a task blocking on an upstream ref while
        # HOLDING the main lane would deadlock against that upstream task
        # queued behind it on this very worker.
        try:
            if (
                tracing.enabled()
                and spec.get("trace_ctx")
                and spec.get("has_ref_args")
            ):
                # Span only when there are actual dependencies to fetch —
                # inline-args resolution is a no-op not worth a record.
                with tracing.span(
                    "fetch_args", parent=spec["trace_ctx"],
                    task_id=spec.get("task_id"),
                ):
                    preresolved = await self._resolve_args_async(spec["args"])
            else:
                preresolved = await self._resolve_args_async(spec["args"])
        except Exception:
            self._record_task_event(spec, "FAILED")
            err = exceptions.TaskError(
                spec.get("name", "task"), traceback.format_exc()
            )
            payload, _ = serialization.serialize(err)
            return {"status": "error", "error": payload}
        return await self._run_on_main(
            lambda: self._execute(spec, fn, False, preresolved)
        )

    async def _run_cross_language(self, spec: dict) -> dict:
        """Execute a cross-language task: import ``module:attr``, call with
        msgpack args, reply with msgpack values (no pickle on the wire, so
        any language speaking the wire format can drive it)."""
        import importlib

        import msgpack

        name = spec.get("name", spec.get("function_ref", "xlang-task"))
        try:
            module_name, _, attr = spec["function_ref"].partition(":")
            if not module_name or not attr:
                raise ValueError(
                    f"function_ref must be 'module:attr', got "
                    f"{spec['function_ref']!r}"
                )
            module = importlib.import_module(module_name)
            fn = module
            for part in attr.split("."):
                fn = getattr(fn, part)
            args = msgpack.unpackb(spec["args"], raw=False) or []
            self._record_task_event(spec, "RUNNING")
            # Main execution lane, like every normal task: a 1-slot worker
            # must not run a cross-language task concurrently with a
            # Python task. (Cancellation of cross-language tasks is not
            # supported yet — no _running_exec registration.)
            value = await self._run_on_main(lambda: fn(*args))
            num_returns = spec.get("num_returns", 1)
            values = [value] if num_returns == 1 else list(value)
            self._record_task_event(spec, "FINISHED")
            return {
                "status": "ok",
                "returns": [
                    {"kind": "msgpack", "data": msgpack.packb(v)}
                    for v in values
                ],
            }
        except Exception:
            self._record_task_event(spec, "FAILED")
            return {
                "status": "error",
                "error_text": f"{name}: {traceback.format_exc()}",
            }

    async def _resolve_args_async(self, payload) -> tuple[tuple, dict]:
        """Async twin of _resolve_args: awaits top-level ObjectRef args on
        the io loop instead of blocking an execution lane."""
        args, kwargs = self._deserialize_args(payload)
        args = tuple(
            [
                (await self.ctx._get_one(a)) if isinstance(a, ObjectRef) else a
                for a in args
            ]
        )
        kwargs = {
            k: (await self.ctx._get_one(v)) if isinstance(v, ObjectRef) else v
            for k, v in kwargs.items()
        }
        return args, kwargs

    async def rpc_create_actor(self, conn, payload) -> dict:
        spec = payload["spec"]
        try:
            cls = await self._load_callable(spec["class_id"])
            concurrency = spec.get("max_concurrency", 1)
            self._actor_concurrency = concurrency
            self._async_sem = None  # built lazily on the io loop
            if concurrency > 1:
                self.executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=concurrency, thread_name_prefix="exec"
                )
            loop = asyncio.get_running_loop()

            def instantiate():
                # Arg resolution may ray_tpu_torch.get() — must run off the io loop.
                args, kwargs = (
                    self._resolve_args(payload["creation_args"])
                    if payload.get("creation_args")
                    else ((), {})
                )
                self.actor_instance = cls(*args, **kwargs)

            await loop.run_in_executor(self.executor, instantiate)
            self.actor_spec = spec
            return {"status": "ok"}
        except Exception:
            return {"status": "error", "error": traceback.format_exc()}

    async def rpc_push_actor_task(self, conn, spec) -> dict:
        if tracing.enabled() and spec.get("trace_ctx"):
            # Arrival stamp: the gap to actual execution becomes the
            # in-actor queue_wait span (ordered/concurrency queue time).
            spec["_arrival_ns"] = _time.time_ns()
        caller = spec.get("caller_id", "?")
        seq = spec.get("seq", 0)
        state = self._order.get(caller)
        if state is None:
            # Baseline on the first seq seen from this caller: after an actor
            # restart the caller's counter does not reset, so "first seen" is
            # the correct start of this incarnation's stream.
            state = self._order[caller] = {"expected": seq, "waiters": {}}
        # Order per caller: wait until all earlier seqs have *started*
        # (actor_scheduling_queue.cc). A bounded wait guards against gaps
        # from callers whose earlier submissions died with a previous
        # incarnation.
        while seq > state["expected"]:
            event = state["waiters"].setdefault(seq, asyncio.Event())
            try:
                # Generous: this releases ONLY when an earlier submission
                # died with a previous actor incarnation; a short timeout
                # misfires as out-of-order execution on a loaded host.
                await asyncio.wait_for(event.wait(), timeout=30.0)
            except asyncio.TimeoutError:
                state["expected"] = seq
                break
        state["expected"] = max(state["expected"], seq + 1)
        for s, ev in list(state["waiters"].items()):
            if s <= state["expected"]:
                ev.set()
                state["waiters"].pop(s, None)
        method_name = spec["method"]
        if self.actor_instance is None:
            payload, _ = serialization.serialize(
                exceptions.ActorDiedError("actor not initialized")
            )
            return {"status": "error", "error": payload}
        if method_name == "__ray_terminate__":
            asyncio.get_running_loop().call_later(0.05, os._exit, 0)
            return {"status": "ok", "returns": [{"kind": "inline", "data": serialization.serialize(None)[0]}]}
        method = getattr(self.actor_instance, method_name, None)
        if method is None:
            payload, _ = serialization.serialize(
                AttributeError(f"actor has no method {method_name!r}")
            )
            return {"status": "error", "error": payload}
        if inspect.iscoroutinefunction(method):
            # Async actor methods run as coroutines on the dedicated actor
            # loop (reference async-actor semantics): awaiting them here
            # costs no executor thread, so long-poll style methods scale to
            # hundreds of concurrent waiters. Concurrency is bounded by the
            # same max_concurrency as sync methods, via a semaphore.
            return await self._execute_async_actor(spec, method)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self.executor, self._execute, spec, method, True
        )

    async def _execute_async_actor(self, spec: dict, method) -> dict:
        name = spec.get("name", "task")
        task_id = spec.get("task_id")
        if task_id in self._cancelled_pending:
            self._cancelled_pending.discard(task_id)
            self._record_task_event(spec, "CANCELLED")
            return {"status": "cancelled"}
        if self._async_sem is None:
            self._async_sem = asyncio.Semaphore(self._actor_concurrency)
        trace_ctx = spec.get("trace_ctx") if tracing.enabled() else None
        arrival_ns = spec.pop("_arrival_ns", None)
        async with self._async_sem:
            if trace_ctx and arrival_ns:
                tracing.emit(
                    "queue_wait", trace_ctx, start_ns=arrival_ns,
                    task_id=task_id, worker_id=self.ctx.worker_id,
                )
            start_ts = _time.time()
            self._record_task_event(spec, "RUNNING")
            if trace_ctx is None:
                return await self._async_actor_body(
                    spec, method, name, task_id, start_ts, None
                )
            with tracing.span(
                f"execute {name}", parent=trace_ctx,
                task_id=task_id, worker_id=self.ctx.worker_id,
            ) as tspan:
                return await self._async_actor_body(
                    spec, method, name, task_id, start_ts, tspan
                )

    async def _async_actor_body(
        self, spec, method, name, task_id, start_ts, trace_span
    ) -> dict:
        rss0 = _peak_rss_bytes()
        hbm0 = self._hbm_used()
        try:
            args, kwargs = await self._resolve_args_async(spec["args"])
            cfut = asyncio.run_coroutine_threadsafe(
                method(*args, **kwargs), self._async_exec_loop()
            )
            self._running_async[task_id] = cfut
            try:
                value = await asyncio.wrap_future(cfut)
            finally:
                self._running_async.pop(task_id, None)
            num_returns = spec.get("num_returns", 1)
            values = [value] if num_returns == 1 else list(value)
            self._record_task_event(
                spec, "FINISHED", start_ts,
                self._task_resources(rss0, hbm0, trace_span),
            )
            return {
                "status": "ok",
                "returns": self._package_returns(spec, values),
            }
        except (asyncio.CancelledError,
                concurrent.futures.CancelledError):
            if trace_span is not None:
                trace_span.status = "cancelled"
            self._record_task_event(spec, "CANCELLED", start_ts)
            return {"status": "cancelled"}
        except Exception as exc:
            if trace_span is not None:
                trace_span.set_error(exc)
            self._record_task_event(
                spec, "FAILED", start_ts,
                self._task_resources(rss0, hbm0, trace_span),
            )
            err = exceptions.TaskError(name, traceback.format_exc())
            payload, _ = serialization.serialize(err)
            return {"status": "error", "error": payload}

    # ------------------------------------------------------------------
    # compiled-graph (rtdag) runtime [SURVEY §2.2 "Compiled graphs"]
    # ------------------------------------------------------------------
    # The driver registers this actor's stage bundle once at compile
    # time; a resident StageLoop per stage (dag/executor.py) then moves
    # every payload over pre-opened channels (shm ring / device p2p
    # plane) — zero controller RPCs and zero per-hop notifies in steady
    # state. Only the legacy socket fallback still rides dag_push/dag_pop.

    async def rpc_dag_register(self, conn, payload) -> dict:
        """The reference builds the actor's ``DagRuntime`` here. The port's
        ``dag.executor.DagRuntime`` is built by a local_tasks actor's
        ``dag_register`` message (it takes that layer's ``send_socket``,
        not this process's context and loop): compiled graphs move onto the
        runtime's actors in ROADMAP Queue A item 14b-ii-b-2, and until then the
        other ``rpc_dag_*`` handlers find no graph registered."""
        raise NotImplementedError(
            "compiled graphs on the runtime's actors are ROADMAP Queue A item "
            "14b-ii-b-2; ray_tpu_torch.dag runs on _private/local_tasks.py")

    def _dag_call(self, method_name: str, args):
        """Run one stage invocation on the actor's single-width executor
        — stage loops pipeline across actors, never within one."""
        method = getattr(self.actor_instance, method_name)
        return self.executor.submit(method, *args).result()

    async def rpc_dag_push(self, conn, payload) -> dict:
        """Socket-fallback edge delivery: feed one buffered input slot."""
        runtime = self._dag_runtimes.get(payload["dag_id"])
        if runtime is None:
            return {"status": "error",
                    "error": f"dag {payload['dag_id']} not registered"}
        push_epoch = int(payload.get("epoch", 0))
        if push_epoch != int(getattr(runtime, "epoch", 0)):
            # Epoch fencing for the socket family: a pre-crash push (or
            # a stale driver) must not feed a re-opened graph.
            return {"status": "stale_epoch", "epoch": runtime.epoch}
        value = serialization.deserialize(payload["value"], zero_copy=False)
        trace = payload.get("trace")
        if trace is not None:
            # Re-wrap the sidecar trace context so the stage loop's
            # buffered-edge pop recovers it like a local edge's envelope.
            from ray_tpu_torch.dag.channels import _TR_WIRE

            value = (_TR_WIRE, trace, value)
        try:
            runtime.feed(payload["node"], payload["slot"],
                         payload["seq"], value)
        except KeyError as exc:
            return {"status": "error", "error": str(exc)}
        return {"status": "ok"}

    async def rpc_dag_pop(self, conn, payload) -> dict:
        """Socket-fallback output pop: await the parked result for seq."""
        runtime = self._dag_runtimes.get(payload["dag_id"])
        if runtime is None:
            return {"status": "error",
                    "error": f"dag {payload['dag_id']} not registered"}
        return await runtime.pop(
            payload["seq"], payload.get("timeout", 300)
        )

    async def rpc_dag_teardown(self, conn, payload) -> dict:
        """Stop the resident loops, free consumer-owned ring slots, and
        leave the per-dag device group. Idempotent."""
        runtime = self._dag_runtimes.pop(payload["dag_id"], None)
        if runtime is not None:
            loop = asyncio.get_running_loop()
            # stop() joins threads that may be blocked in channel ops —
            # keep the io loop free while they wind down.
            await loop.run_in_executor(None, runtime.stop)
        return {"status": "ok"}

    async def rpc_dag_snapshot(self, conn, payload) -> dict:
        """Stateful-actor checkpoint hook: call ``__dag_snapshot__`` on
        the actor instance (if it defines one) and return the serialized
        blob. The driver stores blobs opaquely; ``no_hook`` lets
        stateless stages participate in all-or-nothing snapshots for
        free."""
        hook = getattr(self.actor_instance, "__dag_snapshot__", None)
        if hook is None:
            return {"status": "no_hook"}
        loop = asyncio.get_running_loop()
        try:
            # The hook runs on the actor's single-width executor (state
            # access must serialize with stage invocations), awaited
            # off-loop so a slow snapshot can't wedge the io loop.
            fut = self.executor.submit(hook)
            state_obj = await loop.run_in_executor(None, fut.result)
            blob, _ = serialization.serialize(state_obj)
        except Exception:
            return {"status": "error", "error": traceback.format_exc()}
        return {"status": "ok", "blob": blob}

    async def rpc_dag_restore(self, conn, payload) -> dict:
        """Inverse of dag_snapshot: hand the committed blob back to
        ``__dag_restore__`` — survivors roll back and replacements catch
        up to the same consistent cut before replay starts."""
        hook = getattr(self.actor_instance, "__dag_restore__", None)
        if hook is None:
            return {"status": "no_hook"}
        loop = asyncio.get_running_loop()
        try:
            state_obj = serialization.deserialize(
                payload["blob"], zero_copy=False
            )
            fut = self.executor.submit(hook, state_obj)
            await loop.run_in_executor(None, fut.result)
        except Exception:
            return {"status": "error", "error": traceback.format_exc()}
        return {"status": "ok"}

    async def rpc_cancel_task(self, conn, payload) -> dict:
        """Cancel a task on this worker (reference: CoreWorker::CancelTask →
        task_receiver). force=True kills the process (owner surfaces
        WorkerCrashedError). force=False: main-thread task → SIGINT
        (interrupts blocking C calls, reference semantics); async task →
        cancel its coroutine; sync actor-executor task → best-effort
        async-exc (reference parity: only async actor tasks are reliably
        interruptible); not-yet-started → marked so it returns cancelled
        when dequeued."""
        if payload.get("force"):
            import signal as _signal

            os.kill(os.getpid(), _signal.SIGKILL)
            return {"status": "ok"}  # unreachable
        task_id = payload.get("task_id")
        cfut = self._running_async.get(task_id)
        if cfut is not None:
            cfut.cancel()
            return {"status": "ok"}
        ident = self._running_exec.get(task_id)
        if ident is None:
            self._cancelled_pending.add(task_id)
            return {"status": "not_running"}
        if ident == self._main_ident:
            import signal as _signal

            self._cancel_target = task_id
            os.kill(os.getpid(), _signal.SIGINT)
            return {"status": "ok"}
        import ctypes

        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(ident), ctypes.py_object(KeyboardInterrupt)
        )
        return {"status": "ok"}

    async def rpc_exit(self, conn, payload) -> dict:
        asyncio.get_running_loop().call_later(0.05, os._exit, 0)
        return {"status": "ok"}


def main() -> None:
    from ray_tpu_torch._private import chaos

    chaos.set_identity(f"worker:{os.environ.get('RAYTPU_WORKER_ID', '')}")
    runtime = WorkerRuntime()
    runtime.start()
    # The main thread is the normal-task execution lane (cancellation via
    # SIGINT lands here); RPC/io stay on their own threads.
    runtime.run_main_loop()


if __name__ == "__main__":
    main()
