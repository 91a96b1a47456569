"""DeploymentHandle, DeploymentResponse, ResponseStream and the Router.

Port of ray_tpu's ``serve/handle.py``. A handle keeps a router that tracks
the deployment's live replicas from the membership snapshot
(``long_poll``), picks a replica by rendezvous-hashing the request's
affinity key over them with bounded load (``routing.HashRing``),
preferring replicas that already ran the request's shape key, and sends
the call over the serve wire (``_channel``). Every call carries a
``Deadline``, from the caller (the proxy's header, an enclosing replica
call) or else the deployment's ``request_timeout_s``. When a replica dies
with the call in flight (its connection closes), the call is sent to
another one while the deployment's ``RetryPolicy.max_attempts`` and the
deadline allow; a draining replica moves it without charging the budget.

The dispatch runs on the process's I/O loop; ``.remote()`` returns at
once and ``.result()`` waits from any other thread. Left out (ROADMAP
Queue A item 9): hedging, circuit breakers and model multiplexing.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import math
import threading
import time
import uuid
from typing import Any, Optional

from ray_tpu_torch.serve import _channel
from ray_tpu_torch.serve._common import (
    LEFT_OUT, Deadline, DeadlineExceededError, ReplicaDiedError, ReplicaDrainingError,
    RequestMetadata, RequestShedError, RetryPolicy, TaskError, current_deadline,
)
from ray_tpu_torch.serve.long_poll import get_subscriber
from ray_tpu_torch.serve.routing import HashRing
from ray_tpu_torch.util.backoff import Backoff


_ROUTER_LOCK = threading.Lock()


def _timeout(deadline: Deadline) -> Optional[float]:
    """The seconds to wait for a call under ``deadline`` (None: no limit)."""
    return None if deadline.is_unbounded() else deadline.remaining()


class Router:
    """Hash-ring replica choice over the cached membership, with this
    process's own count of requests in flight on each replica. Used on the
    I/O loop only."""

    # A key's preferred replica is skipped once its ongoing count passes
    # this factor times the fleet's average.
    BOUNDED_LOAD_FACTOR = 1.25
    WARM_REFRESH_S = 2.0

    def __init__(self, deployment: str, app_name: str):
        self.deployment = deployment
        self.app_name = app_name
        self._qualified = f"{app_name}_{deployment}"
        self._replicas: list[str] = []
        self._addresses: dict[str, tuple] = {}
        self._ongoing: dict[str, int] = {}
        # Replicas seen dead, kept out until the membership catches up.
        self._banned: dict[str, float] = {}
        self._max_ongoing = 100
        self._policy: dict = {}
        self._warm: dict[str, set] = {}
        self._warm_ts = 0.0
        self._ring = HashRing()

    # -- policy ---------------------------------------------------------
    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy.from_dict(self._policy.get("retry_policy", {}))

    def request_timeout_s(self) -> float:
        return float(self._policy.get("request_timeout_s", 60.0))

    # -- membership -----------------------------------------------------
    def refresh(self, force: bool = False) -> None:
        subscriber = get_subscriber()
        if force:
            subscriber.force_refresh()
        info = subscriber.get_replicas(self._qualified)
        now = time.monotonic()
        self._banned = {name: until for name, until in self._banned.items() if until > now}
        self._addresses = dict(info.get("addresses", {}))
        self._replicas = [name for name in info["actor_names"] if name not in self._banned]
        self._max_ongoing = info.get("max_ongoing_requests", 100)
        self._policy = info.get("policy", self._policy)
        for name in self._replicas:
            self._ongoing.setdefault(name, 0)

    def peer(self, replica: str) -> _channel.Peer:
        address = self._addresses.get(replica)
        if address is None:
            raise _channel.ConnectionLost(f"replica {replica} has left the membership")
        return _channel.peer(address)

    async def _refresh_warm(self, candidates: list) -> None:
        """Each replica's warm shape keys, asked at most every 2 s under one
        short budget for all of them."""
        if time.monotonic() - self._warm_ts < self.WARM_REFRESH_S:
            return
        self._warm_ts = time.monotonic()

        async def ask(name):
            try:
                return set(await asyncio.wait_for(self.peer(name).call("get_warm_shapes"), 2.0))
            except (ConnectionError, asyncio.TimeoutError, _channel.RemoteError):
                return None

        for name, warm in zip(candidates, await asyncio.gather(*(ask(c) for c in candidates))):
            if warm is None:
                self._warm.pop(name, None)
            else:
                self._warm[name] = warm

    async def choose_replica(self, shape_key: str | None = None,
                             deadline: Deadline | None = None,
                             exclude: set | frozenset = frozenset(),
                             affinity_key: str | None = None) -> str:
        """Picks a replica and takes a slot on it, waiting for capacity or
        membership up to the deadline."""
        deadline = deadline or Deadline.after(self.request_timeout_s())
        # Keyless requests spread: a one-shot random key, stable over this
        # call's wait, gives the ring a uniform choice.
        key = affinity_key or shape_key or uuid.uuid4().hex
        while True:
            self.refresh()
            candidates = [c for c in self._replicas if c not in exclude]
            if candidates and shape_key:
                await self._refresh_warm(candidates)
                warm_free = [c for c in candidates if shape_key in self._warm.get(c, ())
                             and self._ongoing.get(c, 0) < self._max_ongoing]
                # Prefer warm replicas unless they are saturated.
                if warm_free:
                    candidates = warm_free
            if candidates:
                total = sum(self._ongoing.get(c, 0) for c in candidates)
                avg_bound = math.ceil(
                    self.BOUNDED_LOAD_FACTOR * (total + 1) / max(1, len(candidates)))
                self._ring.update(candidates)
                pick = self._ring.pick(key, load=self._ongoing,
                                       max_load=min(self._max_ongoing, max(1, avg_bound)))
                if pick and self._ongoing.get(pick, 0) < self._max_ongoing:
                    self._ongoing[pick] = self._ongoing.get(pick, 0) + 1
                    return pick
            if deadline.expired():
                raise RuntimeError(f"no available replica for {self._qualified} "
                                   f"(backpressure or scale-to-zero)")
            await asyncio.sleep(min(0.05, max(0.005, deadline.remaining())))
            self.refresh(force=True)

    def on_request_done(self, replica: str) -> None:
        if self._ongoing.get(replica, 0) > 0:
            self._ongoing[replica] -= 1

    def drop_replica(self, replica: str) -> None:
        self._replicas = [r for r in self._replicas if r != replica]
        self._banned[replica] = time.monotonic() + 10.0


class DeploymentResponse:
    """The future of one deployment call. ``.result()`` blocks for its
    value; passed into another handle call, it composes (the downstream
    call is sent when this one's value is ready)."""

    def __init__(self, handle: "DeploymentHandle", args: tuple, kwargs: dict,
                 deadline: Optional[Deadline]):
        self._handle = handle
        self._deployment = handle.deployment_name
        self._future: concurrent.futures.Future = _channel.submit(
            self._run(args, kwargs, deadline))

    def result(self, timeout: Optional[float] = None) -> Any:
        """The call's value. ``timeout`` tightens the request's deadline; it
        never extends it."""
        if _channel.on_io_thread():
            raise RuntimeError("DeploymentResponse.result() blocks; it cannot run on the "
                               "serve I/O loop")
        try:
            return self._future.result(timeout)
        except concurrent.futures.TimeoutError:
            self._future.cancel()
            raise DeadlineExceededError(
                f"deadline expired waiting on {self._deployment!r}") from None

    async def _result_async(self) -> Any:
        """The value, awaited on the I/O loop (the proxy's path)."""
        return await asyncio.wrap_future(self._future)

    async def _run(self, args: tuple, kwargs: dict, ambient: Optional[Deadline]) -> Any:
        handle = self._handle
        router = handle._get_router()
        router.refresh()
        if not router._policy:
            router.refresh(force=True)
        deadline = ambient or Deadline.after(router.request_timeout_s())
        policy = router.retry_policy()
        # Compose: an upstream response's value becomes the argument.
        resolved = []
        for arg in args:
            if isinstance(arg, DeploymentResponse):
                arg = await arg._result_async()
                if isinstance(arg, ResponseStream):
                    raise TypeError("a streaming deployment response cannot be composed into a "
                                    "downstream call")
            resolved.append(arg)
        meta = RequestMetadata(method_name=handle._method_name, session_id=handle._session_id)
        backoff = Backoff(policy.initial_backoff_s, policy.max_backoff_s)
        tried: set[str] = set()
        attempts = drains = 0
        while True:
            replica = await router.choose_replica(
                shape_key=handle._shape_key or None, deadline=deadline, exclude=tried,
                affinity_key=handle._session_id or handle._shape_key or None)
            attempts += 1
            tried.add(replica)
            release = True
            try:
                call = router.peer(replica).call(
                    "handle_request",
                    {"request_id": meta.request_id, "method_name": meta.method_name,
                     "shape_key": handle._shape_key, "session_id": meta.session_id,
                     "deadline_budget_s": deadline.budget(), "attempt": attempts - 1},
                    tuple(resolved), kwargs)
                try:
                    value = await asyncio.wait_for(call, _timeout(deadline))
                except asyncio.TimeoutError:
                    raise DeadlineExceededError(
                        f"deadline expired waiting on {self._deployment!r}") from None
                if isinstance(value, dict) and "__serve_stream__" in value:
                    # The stream keeps the router's slot until it ends.
                    release = False
                    return ResponseStream(self, value["__serve_stream__"], replica, deadline)
                return value
            except _channel.ConnectionLost as exc:
                router.drop_replica(replica)
                if attempts >= max(1, policy.max_attempts) or deadline.expired():
                    raise ReplicaDiedError(
                        self._deployment, replica,
                        f"retry budget exhausted after {attempts} attempt(s)") from exc
                await asyncio.sleep(backoff.next_delay(cap=deadline.remaining()))
            except _channel.RemoteError as exc:
                kind = type(exc.error)
                if kind is ReplicaDrainingError:
                    router.drop_replica(replica)
                    attempts -= 1
                    drains += 1
                    if drains > 8 or deadline.expired():
                        raise ReplicaDrainingError(replica) from exc
                    continue
                if kind is RequestShedError:
                    raise RequestShedError(f"replica of {self._deployment!r} shed the request",
                                           retry_after_s=exc.error.retry_after_s) from exc
                if kind is DeadlineExceededError:
                    raise DeadlineExceededError(
                        f"deadline expired inside {self._deployment!r}") from exc
                raise TaskError(f"{replica}.handle_request", exc.remote_traceback) from None
            finally:
                if release:
                    router.on_request_done(replica)


class ResponseStream:
    """Iterator over a streaming deployment's items (token streams), pulled
    from the replica in batches; every pull is bounded by the request's
    deadline. The router's slot is released when the stream ends."""

    def __init__(self, response: DeploymentResponse, stream_id: str, replica: str,
                 deadline: Deadline):
        self._response = response
        self._router = response._handle._get_router()
        self._stream_id = stream_id
        self._replica = replica
        self._deadline = deadline
        self._buffer: list = []
        self._done = False
        self._error: str | None = None

    def __iter__(self):
        return self

    def _raise_end(self):
        # Buffered items drain before a trailing error surfaces.
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"streaming deployment failed: {error}")
        raise StopIteration

    def _finish(self) -> None:
        if not self._done:
            self._done = True
            self._router.on_request_done(self._replica)

    async def _fill(self) -> None:
        while not self._buffer and not self._done:
            if self._deadline.expired():
                await self._cancel()
                raise DeadlineExceededError("stream stalled past the request deadline")
            try:
                chunk = await asyncio.wait_for(
                    self._router.peer(self._replica).call("stream_next", self._stream_id),
                    None if self._deadline.is_unbounded()
                    else max(0.05, self._deadline.remaining()))
            except _channel.ConnectionLost as exc:
                self._finish()
                raise ReplicaDiedError(self._response._deployment, self._replica,
                                       "the stream's replica died") from exc
            self._buffer.extend(chunk.get("items", []))
            if chunk.get("done"):
                self._error = chunk.get("error")
                self._finish()

    async def _next_batch(self) -> list:
        """Every buffered item (pulling one chunk when empty); [] at the end."""
        if not self._buffer and not self._done:
            await self._fill()
        if self._buffer:
            batch, self._buffer = self._buffer, []
            return batch
        if self._error is not None:
            self._raise_end()
        return []

    async def _cancel(self) -> None:
        if not self._done:
            self._finish()
            try:
                await asyncio.wait_for(
                    self._router.peer(self._replica).call("stream_cancel", self._stream_id),
                    max(1.0, self._deadline.remaining(cap=10.0)))
            except (ConnectionError, asyncio.TimeoutError, _channel.RemoteError):
                pass  # the replica's reaper collects what is left

    def __next__(self):
        if not self._buffer:
            if self._done:
                self._raise_end()
            _channel.run_sync(self._fill())
            if not self._buffer:
                self._raise_end()
        return self._buffer.pop(0)

    def next_batch(self) -> list:
        return _channel.run_sync(self._next_batch())

    def cancel(self) -> None:
        _channel.run_sync(self._cancel())


class DeploymentHandle:
    """Calls a deployment: ``handle.remote(...)``, ``handle.method.remote(...)``
    or ``handle.options(method_name=...)``."""

    def __init__(self, deployment: str, app_name: str = "default"):
        self.deployment_name = deployment
        self.app_name = app_name
        self._router: Optional[Router] = None
        self._method_name = "__call__"
        self._shape_key = ""
        self._session_id = ""

    def _get_router(self) -> Router:
        # options() runs on the caller's thread, dispatch on the I/O loop:
        # both must get the one router, or the load counts split.
        with _ROUTER_LOCK:
            if self._router is None:
                self._router = Router(self.deployment_name, self.app_name)
            return self._router

    def options(self, *, method_name: str | None = None,
                multiplexed_model_id: str | None = None, shape_key: str | None = None,
                session_id: str | None = None) -> "DeploymentHandle":
        """``shape_key`` labels the request's shape (a sequence bucket, say):
        such requests prefer replicas that already ran it. ``session_id``
        is the hash ring's affinity key."""
        if multiplexed_model_id:
            raise NotImplementedError(f"model multiplexing is not ported ({LEFT_OUT})")
        clone = DeploymentHandle(self.deployment_name, self.app_name)
        # Option clones share one router, so their load counts agree.
        clone._router = self._get_router()
        clone._method_name = method_name or self._method_name
        clone._shape_key = shape_key or self._shape_key
        clone._session_id = session_id or self._session_id
        return clone

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        # The ambient deadline (the proxy's, or an enclosing replica
        # call's) wins; otherwise the deployment's request timeout.
        return DeploymentResponse(self, args, kwargs, current_deadline())

    def __reduce__(self):
        return (_rebuild_handle, (self.deployment_name, self.app_name, self._method_name,
                                  self._shape_key, self._session_id))

    def __repr__(self):
        return f"DeploymentHandle({self.app_name}/{self.deployment_name})"


def _rebuild_handle(deployment, app_name, method_name, shape_key="", session_id=""):
    handle = DeploymentHandle(deployment, app_name)
    handle._method_name = method_name
    handle._shape_key = shape_key
    handle._session_id = session_id
    return handle


class _HandlePlaceholder:
    """A bound sub-deployment inside init args; the replica turns it into a
    live DeploymentHandle when it builds the class."""

    def __init__(self, deployment: str, app_name: str):
        self.deployment = deployment
        self.app_name = app_name


def _resolve_handle_placeholders(obj: Any) -> Any:
    if isinstance(obj, _HandlePlaceholder):
        return DeploymentHandle(obj.deployment, obj.app_name)
    if isinstance(obj, tuple):
        return tuple(_resolve_handle_placeholders(x) for x in obj)
    if isinstance(obj, list):
        return [_resolve_handle_placeholders(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _resolve_handle_placeholders(v) for k, v in obj.items()}
    return obj
