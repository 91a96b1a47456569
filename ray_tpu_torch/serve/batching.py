"""@batch — dynamic request batching in front of the model.

Port of ray_tpu's ``serve/batching.py``: requests queue until
``max_batch_size`` have arrived or ``batch_wait_timeout_s`` has passed, then
the wrapped function runs once on the list. With ``bucket_sizes`` the
flushed batch is padded up to the nearest bucket by repeating the last
item, so the model sees only a fixed set of batch shapes; the padding is
stripped from the results. A request whose deadline lapsed while queued is
failed with ``DeadlineExceededError`` at the flush instead of being run.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import threading
import weakref
from typing import Any, Callable, Optional, Sequence

from ray_tpu_torch.serve._common import Deadline, DeadlineExceededError, current_deadline

# Shape keys this process has run (one replica per process): bucket
# flushes land here, read by warm_shapes().
_WARM_SHAPES: set[str] = set()
_WARM_LOCK = threading.Lock()

# Live batch queues in this process, weakly held, read by queue_stats().
_QUEUES: "weakref.WeakSet[_BatchQueue]" = weakref.WeakSet()


def queue_stats() -> dict:
    """Batching stats across this process's live queues.

    ``queue_depth`` is the number of requests waiting for a flush now;
    ``batch_occupancy`` is real / padded items of the last flushed batch
    (1.0 without bucket padding), ``avg_occupancy`` the lifetime ratio."""
    depth = 0
    batches = 0
    real = 0
    padded = 0
    last_occ = None
    for queue in list(_QUEUES):
        depth += len(queue.queue)
        batches += queue.batches
        real += queue.items_real
        padded += queue.items_padded
        if queue.last_occupancy is not None:
            last_occ = (
                queue.last_occupancy if last_occ is None
                else min(last_occ, queue.last_occupancy)
            )
    return {
        "queue_depth": depth,
        "batches": batches,
        "items_real": real,
        "items_padded": padded,
        "avg_occupancy": (real / padded) if padded else None,
        "batch_occupancy": last_occ,
    }


def note_warm_shape(key: str) -> None:
    with _WARM_LOCK:
        _WARM_SHAPES.add(key)


def warm_shapes() -> set[str]:
    with _WARM_LOCK:
        return set(_WARM_SHAPES)


class _BatchQueue:
    def __init__(
        self,
        fn: Callable,
        max_batch_size: int,
        batch_wait_timeout_s: float,
        bucket_sizes: Optional[Sequence[int]],
    ):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self.bucket_sizes = sorted(bucket_sizes) if bucket_sizes else None
        if self.bucket_sizes and self.bucket_sizes[-1] < max_batch_size:
            raise ValueError(
                "largest bucket must be >= max_batch_size "
                f"({self.bucket_sizes[-1]} < {max_batch_size})"
            )
        # (item, future, deadline): the request's deadline rides along so a
        # flush can expire entries that waited past their budget.
        self.queue: list[tuple[Any, asyncio.Future, Optional[Deadline]]] = []
        self._flusher: asyncio.Task | None = None
        self._lock = asyncio.Lock()
        # Batches in flight, held so the loop does not drop them.
        self._running: set[asyncio.Task] = set()
        self.batches = 0
        self.items_real = 0
        self.items_padded = 0
        self.last_occupancy: float | None = None
        _QUEUES.add(self)

    def _pad(self, items: list) -> tuple[list, int]:
        real = len(items)
        if self.bucket_sizes:
            bucket = next(
                (b for b in self.bucket_sizes if b >= real), self.bucket_sizes[-1]
            )
            items = items + [items[-1]] * (bucket - real)
            note_warm_shape(f"batch:{bucket}")
        return items, real

    async def submit(self, item: Any) -> Any:
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        async with self._lock:
            self.queue.append((item, future, current_deadline()))
            if len(self.queue) >= self.max_batch_size:
                self._take_and_flush()
            elif self._flusher is None or self._flusher.done():
                self._flusher = asyncio.get_running_loop().create_task(
                    self._flush_after_timeout()
                )
        return await future

    def _take_and_flush(self) -> None:
        batch = self.queue[: self.max_batch_size]
        del self.queue[: self.max_batch_size]
        task = asyncio.get_running_loop().create_task(self._run_batch(batch))
        self._running.add(task)
        task.add_done_callback(self._running.discard)

    async def _flush_after_timeout(self) -> None:
        await asyncio.sleep(self.batch_wait_timeout_s)
        async with self._lock:
            if self.queue:
                self._take_and_flush()

    async def _run_batch(self, batch: list) -> None:
        # Expire entries whose deadline lapsed while queued: running them
        # would spend a batch slot on an answer nobody is waiting for.
        fresh = []
        for item, future, deadline in batch:
            if deadline is not None and deadline.expired():
                if not future.done():
                    future.set_exception(
                        DeadlineExceededError("request expired while queued for batching")
                    )
            else:
                fresh.append((item, future))
        if not fresh:
            return
        items = [item for item, _ in fresh]
        futures = [future for _, future in fresh]
        padded, real = self._pad(items)
        self.batches += 1
        self.items_real += real
        self.items_padded += len(padded)
        self.last_occupancy = real / len(padded) if padded else None
        try:
            result = self.fn(padded)
            if inspect.iscoroutine(result):
                result = await result
            results = list(result)[:real]
            if len(results) != real:
                raise ValueError(
                    f"batched fn returned {len(results)} results for {real} requests"
                )
            for future, value in zip(futures, results):
                if not future.done():
                    future.set_result(value)
        except Exception as exc:
            for future in futures:
                if not future.done():
                    future.set_exception(exc)


def batch(
    _fn: Callable | None = None,
    *,
    max_batch_size: int = 10,
    batch_wait_timeout_s: float = 0.01,
    bucket_sizes: Optional[Sequence[int]] = None,
):
    """Decorator: ``async def fn(self, items: list) -> list``, called per item."""

    def decorator(fn: Callable):
        queues: dict[int, _BatchQueue] = {}

        def _queue_for(bound_args: tuple) -> _BatchQueue:
            # One queue per bound instance (methods) or per function.
            key = id(bound_args[0]) if bound_args else 0
            if key not in queues:
                target = functools.partial(fn, bound_args[0]) if bound_args else fn
                queues[key] = _BatchQueue(
                    target, max_batch_size, batch_wait_timeout_s, bucket_sizes
                )
            return queues[key]

        if "self" in inspect.signature(fn).parameters:
            @functools.wraps(fn)
            async def method_wrapper(self, item):
                return await _queue_for((self,)).submit(item)

            return method_wrapper

        @functools.wraps(fn)
        async def fn_wrapper(item):
            return await _queue_for(()).submit(item)

        return fn_wrapper

    if _fn is not None:
        return decorator(_fn)
    return decorator
