"""Replica: the actor hosting one copy of a deployment.

Port of ray_tpu's ``serve/_private/replica.py``. The controller starts each
replica as a runtime actor (``SERVE_REPLICA::<id>``) whose GPU share the
node agent leases: the actor's worker sees only its lease's card through
``CUDA_VISIBLE_DEVICES``, or none at ``num_gpus`` 0. The actor builds the
user's class (or takes the function) with its init arguments, turns bound
sub-deployments into handles, and then serves its async methods on the
actor's loop: ``handle_request`` runs up to
``max_ongoing_requests`` requests concurrently, so that a ``@batch``
method gathers a batch from them; beyond ``max_ongoing_requests +
max_queued_requests`` it sheds with ``RequestShedError``. The user's async
methods run on that loop, plain ones on a thread pool,
with the request's deadline and metadata in their context
(``get_current_request_metadata``: the multiplexed model id reaches
``serve.get_multiplexed_model_id``). Generator deployments stream through
``stream_next`` / ``stream_cancel``; a stream pins its multiplexed model
until it ends. ``drain`` checkpoints the loaded multiplexed models, and
``cancel_request`` cancels a request a hedge lost. ``get_metrics`` pushes
the occupancy gauges (``util/metrics``) and reports the process's peak RSS
and the launch counts of the port's kernels, which ``kernel_launches``
also answers alone.

The user's class or function reaches the actor by name, never by value
(the serve plane depends on no cloudpickle): a ``CallableRef`` names its
module, its qualified name and the directory its module was imported
from, and the replica imports it.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import functools
import importlib
import importlib.util
import inspect
import logging
import os
import pickle
import signal
import sys
import time
import traceback
import uuid
from typing import Any

from ray_tpu_torch._private import chaos
from ray_tpu_torch.serve import batching
from ray_tpu_torch.serve._common import (
    Deadline, DeadlineExceededError, LatencyHistogram, ReplicaDrainingError, RequestShedError,
    reset_current_deadline, set_current_deadline,
)
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

# The metadata of the request the running code serves (its model id).
_request_context: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_serve_request", default=None)


def get_current_request_metadata():
    return _request_context.get()


class CallableRef:
    """A deployment's class or function by module and qualified name, and
    the directory the module was imported from (the import root a replica
    adds to its path when the module is not already importable there). A
    class of the driver's main script is named by the script's module
    name. At the replica, the name may hold the Deployment the decorator
    made; its class or function is taken."""

    def __init__(self, target: Any):
        self.module = target.__module__
        self.qualname = target.__qualname__
        if "<locals>" in self.qualname:
            raise ValueError(
                f"{self.module}.{self.qualname}: a deployment's class or function must be "
                f"defined at the top level of an importable module (replicas import it)")
        module = sys.modules.get(self.module)
        if self.module == "__main__":
            spec = getattr(module, "__spec__", None)
            path = getattr(module, "__file__", None)
            if spec is not None and spec.name:
                self.module = spec.name
            elif path:
                self.module = os.path.splitext(os.path.basename(path))[0]
            else:
                raise ValueError(f"{self.qualname}: a deployment defined in an interactive "
                                 f"session cannot be imported by its replicas")
        self.root = _import_root(module, self.module)

    def resolve(self) -> Any:
        if self.root and self.root not in sys.path:
            try:
                found = importlib.util.find_spec(self.module) is not None
            except (ImportError, ValueError):
                found = False
            if not found:
                sys.path.append(self.root)
        obj = importlib.import_module(self.module)
        for part in self.qualname.split("."):
            obj = getattr(obj, part)
        return getattr(obj, "func_or_class", obj)

    def __repr__(self):
        return f"{self.module}.{self.qualname}"


def _import_root(module, name: str) -> str:
    """The sys.path entry ``module`` (imported as ``name``) was found under,
    or "" for one without a file."""
    path = getattr(module, "__file__", None)
    if not path:
        return ""
    root = os.path.dirname(os.path.abspath(path))
    depth = name.count(".") + (os.path.basename(path).startswith("__init__.") and 1)
    for _ in range(depth):
        root = os.path.dirname(root)
    return root


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
    """Runs inside a runtime actor with max_concurrency > 1. ``cls_or_fn``
    is the deployment's ``CallableRef``; ``init_args`` may be the pickle of
    ``(init_args, init_kwargs)`` that ``serve.run`` sealed."""

    STREAM_IDLE_TTL_S = 120.0

    def __init__(self, replica_id: str, deployment_name: str, cls_or_fn: Any,
                 init_args: tuple, init_kwargs: dict, user_config: Any, version: str,
                 limits: dict | None = None):
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
        # SIGTERM: stop taking work and let what is in flight finish. The
        # constructor may run off the main thread, where no handler goes in;
        # drain() reaches the replica all the same.
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except (ValueError, OSError):
            pass
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
        # The user's constructor raising is reported by the first health
        # check, which the controller reads as a failed start: the actor
        # itself comes up, so the runtime does not retry it.
        self._callable, self._is_function, self._init_error = None, True, None
        try:
            self._build(cls_or_fn, init_args, init_kwargs, user_config)
        except Exception:
            self._init_error = traceback.format_exc()

    def _build(self, cls_or_fn: Any, init_args: tuple, init_kwargs: dict,
               user_config: Any) -> None:
        from ray_tpu_torch.serve.handle import _resolve_handle_placeholders

        if isinstance(cls_or_fn, CallableRef):
            cls_or_fn = cls_or_fn.resolve()
        if isinstance(init_args, bytes):
            init_args, init_kwargs = pickle.loads(init_args)
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
            engine.deployment = self.deployment_name
            engine.replica_id = self.replica_id
        if user_config is not None:
            self._apply_reconfigure(user_config)

    # -- request path ---------------------------------------------------
    async def handle_request(self, meta: dict, args: tuple, kwargs: dict) -> Any:
        if not (tracing.enabled() and meta.get("trace_ctx")):
            return await self._handle_request_inner(meta, args, kwargs)
        with tracing.span(f"serve.replica {self.deployment_name}", parent=meta["trace_ctx"],
                          replica_id=self.replica_id, request_id=meta.get("request_id")):
            return await self._handle_request_inner(meta, args, kwargs)

    async def _handle_request_inner(self, meta: dict, args: tuple, kwargs: dict) -> Any:
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
        # Chaos: a mid-request kill plays a replica dying while it holds the
        # request; the latency point plays a slow replica.
        try:
            chaos.failpoint("serve.replica.mid_request")
        except chaos.ChaosFault:
            os._exit(1)
        extra = chaos.latency_delay("serve.replica.request")
        if extra > 0:
            await asyncio.sleep(extra)
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

    async def stream_cancel(self, stream_id: str) -> str:
        # Async: it cancels the pump's task on the actor's loop.
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
        if self._init_error is not None:
            raise RuntimeError(f"the replica's constructor raised:\n{self._init_error}")
        # The controller's periodic check doubles as the reaper's tick.
        self._reap_idle_streams()
        if not self._is_function and hasattr(self._callable, "check_health"):
            result = self._callable.check_health()
            if inspect.iscoroutine(result):
                await result
        return "draining" if self._draining else "ok"

    def get_metrics(self) -> dict:
        from ray_tpu_torch._private.worker_proc import _peak_rss_bytes
        from ray_tpu_torch.util import metrics as metrics_mod

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
            "rss_bytes": _peak_rss_bytes(),
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
        # The controller's metrics poll is the gauges' cadence.
        for name in ("ongoing_requests", "queue_depth", "batch_occupancy"):
            value = out["ongoing"] if name == "ongoing_requests" else stats[name]
            if value is not None:
                metrics_mod.set_serve_replica_gauge(name, self.deployment_name, self.replica_id,
                                                    value)
        return out

    def kernel_launches(self) -> dict:
        """The launch counts of the port's kernels in this replica."""
        return kernel_launches()

    async def get_num_ongoing(self) -> int:
        return self._ongoing

    def get_node_id(self) -> str:
        return os.environ.get("RAYTPU_NODE_ID", "")

    async def get_load(self) -> dict:
        """The autoscaler's input: requests in flight and those queued for a
        batch; a serve-LLM decode replica adds its KV pool's free fraction
        (its slots are in-flight requests already). Async, so it is read on
        the actor's loop between two turns of it: a batch's forward that
        holds the loop would otherwise hide the requests that arrived
        meanwhile and start only when it returns."""
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

    async def cancel_request(self, request_id: str, attempt: int) -> bool:
        """Cancels a request in flight (one a hedge lost): an async method or
        a wait for its batch stops; a plain method's thread runs to its end,
        its answer dropped. False if it already ended."""
        task = self._requests.get((request_id, attempt))
        if task is None or task.done():
            return False
        task.cancel()
        return True

    def _on_sigterm(self, signum, frame) -> None:
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
