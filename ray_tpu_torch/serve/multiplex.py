"""@serve.multiplexed: a replica's LRU of loaded models.

The port's copy of ray_tpu's ``serve/multiplex.py``: a replica loads up to
``max_num_models_per_replica`` models, keyed by the request's
``multiplexed_model_id``, and evicts the least recently used one past that,
checkpointing it (``checkpoint`` or ``__serve_checkpoint__``) before it
unloads it (``unload`` or ``__serve_unload__``). A model serving a live
stream is pinned: eviction skips it and is deferred until its last pin
goes. The router sends a model id's requests to the replica that holds it
(``DeploymentHandle.options(multiplexed_model_id=...)``).
"""

from __future__ import annotations

import asyncio
import collections
import functools
import inspect
import logging
from typing import Callable

from ray_tpu_torch.serve.replica import get_current_request_metadata

logger = logging.getLogger(__name__)


def get_multiplexed_model_id() -> str:
    """The model id of the request this code runs for ("" outside one)."""
    meta = get_current_request_metadata()
    if meta is None:
        return ""
    return meta.get("multiplexed_model_id", "")


# Every @multiplexed decorator's caches, so that a draining replica can
# checkpoint its loaded models before its process ends.
_ALL_CACHES: list = []

# Pins of models in active use (a live stream): a pinned model survives the
# eviction scan; the eviction it dodged is kept and run when its last pin
# goes, so the cache still comes back to its bound.
_PINS: dict[str, int] = {}
_DEFERRED: list = []  # (cache, max_models) still over their bound


def pin_model(model_id: str) -> None:
    """Marks a model as in use; each pin needs its ``unpin_model``."""
    if model_id:
        _PINS[model_id] = _PINS.get(model_id, 0) + 1


def unpin_model(model_id: str) -> None:
    """Releases one pin; when a model's last pin goes, the evictions
    deferred meanwhile run (checkpoint, then unload)."""
    if not model_id:
        return
    remaining = _PINS.get(model_id, 0) - 1
    if remaining > 0:
        _PINS[model_id] = remaining
        return
    _PINS.pop(model_id, None)
    if _DEFERRED:
        _schedule_deferred_evictions()


def pinned_models() -> dict[str, int]:
    """model id -> pin count."""
    return dict(_PINS)


async def _call_hook(hook) -> None:
    result = hook()
    if inspect.iscoroutine(result):
        await result


async def _checkpoint_evict(cache, max_models: int, protect: frozenset = frozenset()) -> None:
    """Evicts least recently used first down to ``max_models``, skipping
    pinned models and ``protect`` (the model being loaded, about to be
    handed to its caller): checkpoint, then unload. What pins keep over
    the bound is deferred to the next unpin."""
    for model_id in list(cache.keys()):
        if len(cache) <= max_models:
            break
        if _PINS.get(model_id) or model_id in protect:
            continue
        model = cache.pop(model_id)
        for hook_name in ("checkpoint", "__serve_checkpoint__"):
            hook = getattr(model, hook_name, None)
            if hook is not None:
                try:
                    await _call_hook(hook)
                except Exception as exc:
                    logger.warning("checkpoint of evicted model %r failed: %s", model_id, exc)
                break
        unload = getattr(model, "unload", None) or getattr(model, "__serve_unload__", None)
        if unload is not None:
            await _call_hook(unload)
    if len(cache) > max_models and (cache, max_models) not in _DEFERRED:
        _DEFERRED.append((cache, max_models))


async def _drain_deferred_evictions() -> None:
    pending, _DEFERRED[:] = list(_DEFERRED), []
    for cache, max_models in pending:
        await _checkpoint_evict(cache, max_models)


def _schedule_deferred_evictions() -> None:
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        # No running loop (an unpin from plain code): drain here.
        asyncio.run(_drain_deferred_evictions())
        return
    task = loop.create_task(_drain_deferred_evictions())
    _EVICTIONS.add(task)
    task.add_done_callback(_EVICTIONS.discard)


# Deferred evictions in flight, held so that the loop does not drop them.
_EVICTIONS: set = set()


async def checkpoint_loaded_models() -> int:
    """Checkpoints every model loaded through @multiplexed in this process;
    returns how many. A model whose checkpoint fails is logged and skipped:
    a drain must not stop on one broken model."""
    count = 0
    for caches in _ALL_CACHES:
        for cache in caches.values():
            for model_id, model in list(cache.items()):
                hook = (getattr(model, "checkpoint", None)
                        or getattr(model, "__serve_checkpoint__", None))
                if hook is None:
                    continue
                try:
                    await _call_hook(hook)
                    count += 1
                except Exception as exc:
                    logger.warning("checkpoint of multiplexed model %r failed: %s",
                                   model_id, exc)
    return count


def multiplexed(_fn: Callable | None = None, *, max_num_models_per_replica: int = 3):
    """Decorates ``async def load(self, model_id) -> model`` (or a function
    of the model id alone): one LRU of loaded models an instance."""

    def decorator(load_fn: Callable):
        caches: dict[int, collections.OrderedDict] = {}
        locks: dict[int, asyncio.Lock] = {}
        _ALL_CACHES.append(caches)

        @functools.wraps(load_fn)
        async def wrapper(*args):
            # (self, model_id) for a method, (model_id,) for a function.
            key = id(args[0]) if len(args) > 1 else 0
            model_id = args[-1]
            cache = caches.setdefault(key, collections.OrderedDict())
            lock = locks.setdefault(key, asyncio.Lock())
            async with lock:
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                model = load_fn(*args)
                if inspect.iscoroutine(model):
                    model = await model
                cache[model_id] = model
                await _checkpoint_evict(cache, max_num_models_per_replica,
                                        protect=frozenset((model_id,)))
                return model

        return wrapper

    if _fn is not None:
        return decorator(_fn)
    return decorator
