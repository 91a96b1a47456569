"""Replica: one copy of a deployment, in a process of its own.

Port of ray_tpu's ``serve/_private/replica.py``. The controller starts each
replica from the ``torch.multiprocessing`` spawn context (a driver that has
initialised CUDA cannot fork), with ``CUDA_VISIBLE_DEVICES`` set to the
card it placed the replica on, or to none for a replica that asks for no
card. The process builds the user's class (or takes the function) with its
init arguments, turns bound sub-deployments into handles, and then serves
calls on one asyncio loop: ``handle_request`` runs up to
``max_ongoing_requests`` requests concurrently, so that a ``@batch``
method gathers a batch from them; beyond ``max_ongoing_requests +
max_queued_requests`` it sheds with ``RequestShedError``. Async methods run
on the loop, plain ones on a thread pool (the reference's actor threads),
with the request's deadline and metadata in their context
(``get_current_request_metadata``: the multiplexed model id reaches
``serve.get_multiplexed_model_id``). Generator deployments stream through
``stream_next`` / ``stream_cancel``; a stream pins its multiplexed model
until it ends. ``drain`` checkpoints the loaded multiplexed models, and
``cancel_request`` cancels a request a hedge lost.

The class or function reaches the process by name, never by value (the
port depends on no cloudpickle): it must be importable from a module,
at the module's top level.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import functools
import importlib
import inspect
import logging
import os
import signal
import sys
import threading
import time
import traceback
import uuid
from typing import Any

from ray_tpu_torch.serve import _channel, batching, long_poll
from ray_tpu_torch.serve._common import (
    Deadline, DeadlineExceededError, LatencyHistogram, ReplicaDrainingError, RequestShedError,
    reset_current_deadline, set_current_deadline,
)

logger = logging.getLogger(__name__)

# The metadata of the request the running code serves (its model id).
_request_context: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_serve_request", default=None)


def get_current_request_metadata():
    return _request_context.get()


class CallableRef:
    """A deployment's class or function by module and qualified name. At the
    replica, the name may hold the Deployment the decorator made; its
    class or function is taken."""

    def __init__(self, target: Any):
        self.module = target.__module__
        self.qualname = target.__qualname__
        if "<locals>" in self.qualname:
            raise ValueError(
                f"{self.module}.{self.qualname}: a deployment's class or function must be "
                f"defined at the top level of an importable module (replicas import it)")

    def resolve(self) -> Any:
        obj = importlib.import_module(self.module)
        for part in self.qualname.split("."):
            obj = getattr(obj, part)
        return getattr(obj, "func_or_class", obj)

    def __repr__(self):
        return f"{self.module}.{self.qualname}"


# The calls a replica answers.
_METHODS = frozenset({
    "handle_request", "stream_next", "stream_cancel", "reconfigure", "check_health",
    "get_metrics", "get_load", "get_num_ongoing", "get_warm_shapes", "drain", "cancel_request",
})


class _Stream:
    """A generator's items on their way to the caller: a bounded queue
    (backpressure on the generator) read in batches."""

    def __init__(self, maxsize: int = 256):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize)
        self.task: asyncio.Task | None = None
        self.last_access = time.monotonic()
        self.model_id = ""

    async def pop_batch(self, max_items: int, timeout_s: float) -> list:
        """At least one event (waiting up to timeout_s), then up to
        max_items without waiting."""
        try:
            first = await asyncio.wait_for(self.queue.get(), timeout_s)
        except asyncio.TimeoutError:
            return []
        events = [first]
        while len(events) < max_items and not self.queue.empty():
            events.append(self.queue.get_nowait())
        return events


class Replica:
    """Serves one deployment in this process."""

    STREAM_IDLE_TTL_S = 120.0

    def __init__(self, replica_id: str, deployment_name: str, cls_or_fn: Any,
                 init_args: tuple, init_kwargs: dict, user_config: Any, version: str,
                 limits: dict | None = None):
        from ray_tpu_torch.serve.handle import _resolve_handle_placeholders

        self.replica_id = replica_id
        self.deployment_name = deployment_name
        self.version = version
        self._ongoing = 0
        self._total = 0
        self._shed = 0
        limits = limits or {}
        self._max_ongoing = int(limits.get("max_ongoing_requests", 100))
        max_queued = int(limits.get("max_queued_requests", -1))
        # Admission ceiling: capacity plus the queue allowance (-1: 1x).
        self._admission_limit = self._max_ongoing + (
            self._max_ongoing if max_queued < 0 else max_queued)
        self._draining = False
        self._latency_hist = LatencyHistogram()
        self._streams: dict[str, _Stream] = {}
        self._stream_counter = 0
        # Stream ids name this incarnation, so an id from a dead one misses.
        self._incarnation = uuid.uuid4().hex[:6]
        self._warm_shapes: set[str] = set()
        # The tasks of requests in flight, by (request id, attempt).
        self._requests: dict[tuple, asyncio.Task] = {}
        # Plain (not async) methods run here, as the reference's actor
        # threads run them.
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(8, self._max_ongoing), thread_name_prefix="replica")
        init_args = _resolve_handle_placeholders(init_args)
        init_kwargs = _resolve_handle_placeholders(init_kwargs)
        if isinstance(cls_or_fn, type):
            self._callable = cls_or_fn(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self._callable = cls_or_fn
            self._is_function = True
        # A callable hosting a serve-LLM decode engine gets its identity
        # stamped here: the engine cannot know its replica when it is built.
        engine = getattr(self._callable, "_engine", None)
        if engine is not None and hasattr(engine, "replica_id"):
            engine.deployment = deployment_name
            engine.replica_id = replica_id
        if user_config is not None:
            self._apply_reconfigure(user_config)

    async def dispatch(self, method: str, args: tuple, kwargs: dict) -> Any:
        if method not in _METHODS:
            raise AttributeError(f"a replica has no call {method!r}")
        result = getattr(self, method)(*args, **kwargs)
        if inspect.isawaitable(result):
            result = await result
        return result

    # -- request path ---------------------------------------------------
    async def handle_request(self, meta: dict, args: tuple, kwargs: dict) -> Any:
        for arg in args:
            if isinstance(arg, dict) and "__serve_stream__" in arg:
                raise TypeError(
                    "a streaming deployment response cannot be composed into a downstream "
                    "call: iterate the stream in the caller and pass materialized values")
        # The wire carries a relative budget: re-anchor it on this clock.
        budget = meta.get("deadline_budget_s")
        deadline = Deadline.after(budget) if budget is not None else Deadline.never()
        if deadline.expired():
            raise DeadlineExceededError("request deadline expired before the replica started it")
        if self._draining:
            raise ReplicaDrainingError(self.replica_id)
        if self._ongoing >= self._admission_limit:
            self._shed += 1
            raise RequestShedError(
                f"replica {self.replica_id} over admission limit "
                f"({self._ongoing} >= {self._admission_limit})")
        self._ongoing += 1
        self._total += 1
        start = time.perf_counter()
        key = (meta.get("request_id"), meta.get("attempt", 0))
        self._requests[key] = asyncio.current_task()
        token = _request_context.set(meta)
        deadline_token = set_current_deadline(deadline)
        try:
            if self._is_function:
                target = self._callable
            else:
                target = getattr(self._callable, meta.get("method_name", "__call__"))
            if (inspect.iscoroutinefunction(target) or inspect.isgeneratorfunction(target)
                    or inspect.isasyncgenfunction(target)):
                result = target(*args, **kwargs)
            else:
                context = contextvars.copy_context()
                result = await asyncio.get_running_loop().run_in_executor(
                    self._pool, functools.partial(context.run, target, *args, **kwargs))
            if inspect.iscoroutine(result):
                result = await result
            if inspect.isgenerator(result) or inspect.isasyncgen(result):
                # A live stream is an ongoing request until it finishes.
                stream_id = self._open_stream(result, meta.get("multiplexed_model_id", ""))
                self._ongoing += 1  # released by _finish_stream
                if meta.get("shape_key"):
                    self._warm_shapes.add(meta["shape_key"])
                return {"__serve_stream__": stream_id}
            # Warmth is recorded on success only.
            if meta.get("shape_key"):
                self._warm_shapes.add(meta["shape_key"])
            return result
        finally:
            reset_current_deadline(deadline_token)
            _request_context.reset(token)
            self._requests.pop(key, None)
            self._ongoing -= 1
            self._latency_hist.observe(time.perf_counter() - start)

    # -- streaming ------------------------------------------------------
    def _open_stream(self, gen, model_id: str = "") -> str:
        stream_id = f"stream-{self.replica_id}-{self._incarnation}-{self._stream_counter}"
        self._stream_counter += 1
        stream = _Stream()
        stream.task = asyncio.get_running_loop().create_task(self._pump(gen, stream))
        # An eviction must not checkpoint and unload the model a live
        # stream still runs: it waits for the stream's end.
        if model_id:
            from ray_tpu_torch.serve import multiplex

            multiplex.pin_model(model_id)
            stream.model_id = model_id
        self._streams[stream_id] = stream
        self._reap_idle_streams()
        return stream_id

    def _finish_stream(self, stream_id: str) -> None:
        stream = self._streams.pop(stream_id, None)
        if stream is not None:
            stream.task.cancel()
            if stream.model_id:
                from ray_tpu_torch.serve import multiplex

                multiplex.unpin_model(stream.model_id)
            self._ongoing -= 1

    def _reap_idle_streams(self) -> None:
        """An abandoned stream must not hold its generator and slot forever."""
        now = time.monotonic()
        for stream_id, stream in list(self._streams.items()):
            if now - stream.last_access > self.STREAM_IDLE_TTL_S:
                self._finish_stream(stream_id)

    async def _pump(self, gen, stream: _Stream) -> None:
        """Drains the generator into the stream; {'done': True} or
        {'error': text} ends it."""
        try:
            if inspect.isasyncgen(gen):
                async for item in gen:
                    await stream.queue.put({"item": item})
            else:
                for item in gen:
                    await stream.queue.put({"item": item})
                    await asyncio.sleep(0)  # let readers interleave
            await stream.queue.put({"done": True})
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            await stream.queue.put({"error": f"{type(exc).__name__}: {exc}"})

    async def stream_next(self, stream_id: str, max_items: int = 64,
                          timeout_s: float = 30.0) -> dict:
        stream = self._streams.get(stream_id)
        if stream is None:
            return {"items": [], "done": True, "error": "unknown stream"}
        stream.last_access = time.monotonic()
        events = await stream.pop_batch(max_items, timeout_s)
        stream.last_access = time.monotonic()
        items: list = []
        done, error = False, None
        for event in events:
            if "item" in event:
                items.append(event["item"])
            else:
                done, error = True, event.get("error")
                break
        if done:
            self._finish_stream(stream_id)
        out = {"items": items, "done": done}
        if error:
            out["error"] = error
        return out

    def stream_cancel(self, stream_id: str) -> str:
        self._finish_stream(stream_id)
        return "ok"

    # -- control plane --------------------------------------------------
    def reconfigure(self, user_config: Any) -> str:
        self._apply_reconfigure(user_config)
        return "ok"

    def _apply_reconfigure(self, user_config: Any) -> None:
        if not self._is_function and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    async def check_health(self) -> str:
        # The controller's periodic check doubles as the reaper's tick.
        self._reap_idle_streams()
        if not self._is_function and hasattr(self._callable, "check_health"):
            result = self._callable.check_health()
            if inspect.iscoroutine(result):
                await result
        return "draining" if self._draining else "ok"

    def get_metrics(self) -> dict:
        lat = self._latency_hist.snapshot()
        stats = batching.queue_stats()
        out = {
            "replica_id": self.replica_id,
            "pid": os.getpid(),
            "ongoing": self._ongoing,
            "total": self._total,
            "shed": self._shed,
            "draining": self._draining,
            "p50_ms": lat["p50_ms"],
            "p95_ms": lat["p95_ms"],
            "p99_ms": lat["p99_ms"],
            "queue_depth": stats["queue_depth"],
            "batches": stats["batches"],
            "batch_occupancy": stats["batch_occupancy"],
            "avg_batch_occupancy": stats["avg_occupancy"],
            "items_real": stats["items_real"],
            "items_padded": stats["items_padded"],
            "kernels": kernel_launches(),
        }
        # A serve-LLM decode engine's slot occupancy stands for the batch
        # occupancy: its gauges follow the running batch.
        stats_fn = getattr(self._callable, "serve_llm_stats", None)
        if callable(stats_fn):
            llm_stats = stats_fn()
            out["serve_llm"] = llm_stats
            out["queue_depth"] += llm_stats.get("queue_depth", 0)
            out["batch_occupancy"] = llm_stats.get("slot_occupancy_frac")
        return out

    def get_num_ongoing(self) -> int:
        return self._ongoing

    def get_load(self) -> dict:
        """The autoscaler's input: requests in flight and those queued for a
        batch; a serve-LLM decode replica adds its KV pool's free fraction
        (its slots are in-flight requests already)."""
        load = {"ongoing": self._ongoing, "queue_depth": batching.queue_stats()["queue_depth"],
                "draining": self._draining}
        load_fn = getattr(self._callable, "serve_llm_load", None)
        if callable(load_fn):
            load["kv_free_frac"] = load_fn().get("kv_free_frac")
        return load

    def get_warm_shapes(self) -> list:
        """Shape keys served here and the batch buckets run: the router
        prefers warm replicas."""
        return sorted(self._warm_shapes | batching.warm_shapes())

    async def drain(self, checkpoint: bool = True) -> dict:
        """Stops taking new requests, checkpoints the loaded multiplexed
        models (on the first drain), and reports what is still in flight."""
        first = not self._draining
        self._draining = True
        checkpointed = 0
        if checkpoint and first:
            from ray_tpu_torch.serve import multiplex

            checkpointed = await multiplex.checkpoint_loaded_models()
        return {"draining": True, "ongoing": self._ongoing, "streams": len(self._streams),
                "checkpointed_models": checkpointed}

    def cancel_request(self, request_id: str, attempt: int) -> bool:
        """Cancels a request in flight (one a hedge lost): an async method or
        a wait for its batch stops; a plain method's thread runs to its end,
        its answer dropped. False if it already ended."""
        task = self._requests.get((request_id, attempt))
        if task is None or task.done():
            return False
        task.cancel()
        return True

    def on_sigterm(self) -> None:
        logger.info("replica %s received SIGTERM: draining", self.replica_id)
        self._draining = True


def kernel_launches() -> dict:
    """The launch counts of the port's kernel wrappers this process has
    imported, with the flash kernels' counts by route."""
    out = {}
    flash = sys.modules.get("ray_tpu_torch.ops.flash_attention")
    if flash is not None:
        for name, fn in (("flash_attention_fwd", flash.flash_attention),
                         ("flash_attention_bwd_dq", flash._flash_bwd_dq),
                         ("flash_attention_bwd_dkv", flash._flash_bwd_dkv)):
            out[name] = {"launches": fn.launches, "launches_by_route": dict(fn.launches_by_route)}
    norm = sys.modules.get("ray_tpu_torch.ops.rmsnorm")
    if norm is not None:
        out["rmsnorm"] = {"launches": norm.rmsnorm.launches}
        out["rmsnorm_bwd"] = {"launches": norm.rmsnorm_backward.launches}
    return out


# -- the process -------------------------------------------------------------
def replica_main(spec: dict, conn) -> None:
    """A replica process: build the replica, serve on a localhost port,
    tell the controller through ``conn``, and stop when it says so or
    closes the pipe."""
    os.environ.update(spec["env"])
    try:
        asyncio.run(_serve(spec, conn))
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        # Plain-method threads and the I/O loop's connections end with the
        # process; nothing waits for them.
        os._exit(0)


async def _serve(spec: dict, conn) -> None:
    loop = asyncio.get_running_loop()
    long_poll.set_controller_address(spec["controller"])
    try:
        replica = Replica(spec["replica_id"], spec["deployment"], spec["callable"].resolve(),
                          spec["init_args"], spec["init_kwargs"], spec["user_config"],
                          spec["version"], limits=spec["limits"])
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    server = await asyncio.start_server(
        functools.partial(_channel.serve_connection, dispatch=replica.dispatch), "127.0.0.1", 0)
    stop = asyncio.Event()
    try:
        loop.add_signal_handler(signal.SIGTERM, replica.on_sigterm)
    except (NotImplementedError, RuntimeError):
        pass  # no signal handlers on this platform; drain() still reaches it

    def watch():
        # The controller says stop, or its end of the pipe closes with it.
        try:
            while conn.recv() != ("stop",):
                pass
        except (EOFError, OSError):
            pass
        loop.call_soon_threadsafe(stop.set)

    conn.send(("ready", {"address": server.sockets[0].getsockname()[:2], "pid": os.getpid()}))
    threading.Thread(target=watch, name="replica-stop", daemon=True).start()
    await stop.wait()
    # No wait for the callers' connections to close: the process ends.
    server.close()
