"""DeploymentHandle, DeploymentResponse, ResponseStream and the Router.

Port of ray_tpu's ``serve/handle.py``. A handle keeps a router that tracks
the deployment's live replicas from the membership snapshot
(``long_poll``), picks a replica by rendezvous-hashing the request's
affinity key over them with bounded load (``routing.HashRing``; the key
is the session id, else the multiplexed model id, else the shape key),
preferring replicas that already ran the request's shape key, and calls
the replica's actor (``SERVE_REPLICA::<id>``, looked up by name once) on
the runtime. Every call carries a
``Deadline``, from the caller (the proxy's header, an enclosing replica
call) or else the deployment's ``request_timeout_s``.

Each dispatch of a request onto a replica is an attempt: an actor call
whose ref the response awaits under the request's deadline. When a replica
dies with an attempt in flight (the runtime fails its ref with
``ActorDiedError``), the request is
sent to another one while the deployment's ``RetryPolicy.max_attempts``
and the deadline allow; a draining replica moves it without charging the
budget. With ``RetryPolicy.hedge``, a second attempt goes to another
replica once the first has run ``hedge_after_s`` (or the route's observed
p95): the first answer wins, and the loser is cancelled. An attempt shed
by its replica is dropped: while another attempt runs, that one goes on;
otherwise the request moves, free of the retry budget and the breaker, to
a replica it has not tried that has room now, and is shed only when no
such replica is left (the reference's handle ends the request at its
first shed). A replica's
circuit breaker opens after consecutive deaths and keeps it out of the
candidates until its cooldown lets one probe through. Every attempt gives
its router slot back exactly once. A replica's own refusals (draining,
shed, an expired deadline) cross the runtime as a ``TaskError`` whose
traceback ends in their class, as the reference's do. Retries, hedges,
deadline expiries and breaker states feed ``util/metrics``.

The dispatch runs on the process's serve I/O loop (``io_loop``), where the
proxy serves too: ``.remote()`` returns at once, ``.result()`` waits from
any other thread, and a thread of the settle pool waits in the runtime's
engine for each call's reply, so the loop itself never blocks on one.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import math
import re
import threading
import time
import uuid
from typing import Any, Awaitable, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch.serve._common import (
    Deadline, DeadlineExceededError, ReplicaDiedError, ReplicaDrainingError,
    RequestMetadata, RequestShedError, RetryPolicy, current_deadline,
)
from ray_tpu_torch.serve.long_poll import get_subscriber
from ray_tpu_torch.serve.routing import HashRing
from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.backoff import Backoff


_ROUTER_LOCK = threading.Lock()


# -- the process's serve I/O loop -------------------------------------------
_loop: asyncio.AbstractEventLoop | None = None
_loop_lock = threading.Lock()


def io_loop() -> asyncio.AbstractEventLoop:
    """This process's serve I/O loop, started on a daemon thread at first
    use: the handles' dispatch and, in a proxy, its server run on it."""
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


def submit(coro: Awaitable) -> concurrent.futures.Future:
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


# -- calls to replicas --------------------------------------------------------
class ReplicaGoneError(exceptions.ActorDiedError):
    """The replica's actor could not be found: it left since the pick."""


# Failures of an attempt's ref that mean the replica's process is gone, as
# opposed to a slow request or the user's code raising.
_REPLICA_DEATH_ERRORS = (exceptions.ActorDiedError, exceptions.ActorUnavailableError,
                        exceptions.WorkerCrashedError)

# A replica's own refusals cross the runtime as a TaskError that carries
# only the remote traceback; its last line names the class.
_REMOTE_ERROR_KINDS = ("ReplicaDrainingError", "RequestShedError", "DeadlineExceededError")


def _remote_error_kind(exc: BaseException) -> Optional[str]:
    if isinstance(exc, exceptions.TaskError):
        lines = (exc.remote_traceback or "").strip().splitlines()
        last = lines[-1] if lines else ""
        for kind in _REMOTE_ERROR_KINDS:
            if kind in last:
                return kind
    return None


# The threads that wait for this process's calls to replicas: a call on
# the runtime's direct lane settles in a thread blocked in the engine's
# wait, one a call in flight.
_SETTLE_THREADS = concurrent.futures.ThreadPoolExecutor(256, thread_name_prefix="serve-settle")


async def call_actor(actor, method: str, *args) -> Any:
    """``actor.method(*args)`` through the runtime, its ref awaited on this
    loop: the call settles on a thread of ``_SETTLE_THREADS`` and its reply
    is read here, with no hop through the runtime's io loop."""
    from ray_tpu_torch._private import worker

    ref = actor._invoke(method, args, {})
    return await worker.get_global_context().get_on_loop(ref, _SETTLE_THREADS)


class CircuitBreaker:
    """A replica's breaker: consecutive failures open it; after a cooldown
    it half-opens (one probe may pass); a success closes it. States: 0
    closed, 1 half-open, 2 open."""

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2
    NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    def can_route(self) -> bool:
        with self._lock:
            if self.state == self.OPEN:
                if time.monotonic() - self._opened_at >= self.cooldown_s:
                    self.state = self.HALF_OPEN
                    return True
                return False
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self.state = self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self.state == self.HALF_OPEN or self._failures >= self.failure_threshold:
                self.state = self.OPEN
                self._opened_at = time.monotonic()


class _Attempt:
    """One dispatch of a request onto a replica; its router slot is given
    back exactly once."""

    __slots__ = ("replica", "task", "number", "hedge", "launched_at", "released", "discarded")

    def __init__(self, replica: str, task: asyncio.Task, number: int, hedge: bool):
        self.replica = replica
        self.task = task
        self.number = number
        self.hedge = hedge
        self.launched_at = time.monotonic()
        self.released = False
        self.discarded = False


class Router:
    """Hash-ring replica choice over the cached membership, with this
    process's own count of requests in flight on each replica, each
    replica's circuit breaker, and the route's completed latencies (the
    hedge's trigger). Used on the I/O loop only."""

    # A key's preferred replica is skipped once its ongoing count passes
    # this factor times the fleet's average.
    BOUNDED_LOAD_FACTOR = 1.25
    WARM_REFRESH_S = 2.0
    # The hedge's delay until 8 latencies have been seen.
    DEFAULT_P95_S = 1.0
    # How long a replica seen dead stays out of the candidates.
    BAN_S = 10.0

    def __init__(self, deployment: str, app_name: str):
        self.deployment = deployment
        self.app_name = app_name
        self._qualified = f"{app_name}_{deployment}"
        self._replicas: list[str] = []
        # Replica actors by name, looked up once each.
        self._handles: dict[str, Any] = {}
        self._ongoing: dict[str, int] = {}
        # Replicas seen dead, kept out until the membership catches up.
        self._banned: dict[str, float] = {}
        self._max_ongoing = 100
        self._policy: dict = {}
        self._warm: dict[str, set] = {}
        self._warm_ts = 0.0
        self._ring = HashRing()
        self._breakers: dict[str, CircuitBreaker] = {}
        self._latencies: collections.deque = collections.deque(maxlen=128)
        # hedges_launched / _won / _lost / _skipped, attempt_deaths,
        # attempts_shed, shed_moves, retries, and each breaker state seen,
        # for get_reliability_stats.
        self.stats: collections.Counter = collections.Counter()
        self.breaker_states_seen: set[str] = set()

    # -- policy ---------------------------------------------------------
    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy.from_dict(self._policy.get("retry_policy", {}))

    def request_timeout_s(self) -> float:
        return float(self._policy.get("request_timeout_s", 60.0))

    def breaker(self, replica: str) -> CircuitBreaker:
        found = self._breakers.get(replica)
        if found is None:
            found = self._breakers[replica] = CircuitBreaker()
        return found

    def note_breaker(self, replica: str) -> None:
        self.breaker_states_seen.add(CircuitBreaker.NAMES[self.breaker(replica).state])

    def report_breaker(self, replica: str) -> None:
        """The breaker's state gauge, set where a failure moved it."""
        self.note_breaker(replica)
        metrics_mod.set_serve_breaker_state(self._qualified, replica,
                                            self.breaker(replica).state)

    def note_latency(self, seconds: float) -> None:
        self._latencies.append(seconds)

    def observed_p95(self) -> float:
        """The p95 of the route's completed latencies here; the hedge's
        delay when ``hedge_after_s`` is unset."""
        samples = sorted(self._latencies)
        if len(samples) < 8:
            return self.DEFAULT_P95_S
        return samples[min(len(samples) - 1, int(0.95 * len(samples)))]

    def reliability(self) -> dict:
        """Hedges, retries and breaker states, for the proxy's stats."""
        return {**self.stats, "breaker_states_seen": sorted(self.breaker_states_seen),
                "breakers": {name: CircuitBreaker.NAMES[b.state]
                             for name, b in self._breakers.items()}}

    # -- membership -----------------------------------------------------
    def refresh(self, force: bool = False) -> None:
        subscriber = get_subscriber()
        if force:
            subscriber.force_refresh()
        info = subscriber.get_replicas(self._qualified)
        now = time.monotonic()
        self._banned = {name: until for name, until in self._banned.items() if until > now}
        self._replicas = [name for name in info["actor_names"] if name not in self._banned]
        self._max_ongoing = info.get("max_ongoing_requests", 100)
        self._policy = info.get("policy", self._policy)
        for name in self._replicas:
            self._ongoing.setdefault(name, 0)

    def replica_handle(self, replica: str):
        """The replica's actor; ReplicaGoneError if the runtime no longer has
        it."""
        found = self._handles.get(replica)
        if found is None:
            from ray_tpu_torch.actor import get_actor

            try:
                found = self._handles[replica] = get_actor(replica)
            except ValueError:
                raise ReplicaGoneError(f"replica {replica} has left the runtime") from None
        return found

    async def call(self, replica: str, method: str, *args) -> Any:
        return await call_actor(self.replica_handle(replica), method, *args)

    async def _refresh_warm(self, candidates: list) -> None:
        """Each replica's warm shape keys, asked at most every 2 s under one
        short budget for all of them."""
        if time.monotonic() - self._warm_ts < self.WARM_REFRESH_S:
            return
        self._warm_ts = time.monotonic()

        async def ask(name):
            try:
                return set(await asyncio.wait_for(self.call(name, "get_warm_shapes"), 2.0))
            except (exceptions.RayTpuError, asyncio.TimeoutError):
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
            # An open breaker takes its replica out of the candidates,
            # unless every candidate's is open (a probe beats an error).
            routable = [c for c in candidates if self.breaker(c).can_route()]
            if routable:
                candidates = routable
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
        self._banned[replica] = time.monotonic() + self.BAN_S
        self._handles.pop(replica, None)


# Best-effort cancels of lost attempts, held so the loop does not drop them.
_CANCELS: set = set()


class DeploymentResponse:
    """The future of one deployment call. ``.result()`` blocks for its
    value; passed into another handle call, it composes (the downstream
    call is sent when this one's value is ready)."""

    def __init__(self, handle: "DeploymentHandle", args: tuple, kwargs: dict,
                 deadline: Optional[Deadline]):
        self._handle = handle
        self._deployment = handle.deployment_name
        self._attempts: list[_Attempt] = []
        self._hedged = False
        self._drain_moves = 0
        self._shed_moves = 0
        # The caller's span (a proxy's serve.request, a replica's span, a
        # driver's own) parents the replica's span across the call.
        self._trace_ctx = tracing.inject()
        # Made on the I/O loop (the proxy's requests), the call runs as a
        # task of it; from any other thread, it is handed to the loop.
        self._task: Optional[asyncio.Task] = None
        self._future: Optional[concurrent.futures.Future] = None
        if on_io_thread():
            self._task = asyncio.ensure_future(self._run(args, kwargs, deadline))
        else:
            self._future = submit(self._run(args, kwargs, deadline))

    def result(self, timeout: Optional[float] = None) -> Any:
        """The call's value. ``timeout`` tightens the request's deadline; it
        never extends it."""
        if on_io_thread():
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
        if self._task is not None:
            return await self._task
        return await asyncio.wrap_future(self._future)

    async def _run(self, args: tuple, kwargs: dict, ambient: Optional[Deadline]) -> Any:
        handle = self._handle
        router = self._router = handle._get_router()
        router.refresh()
        if not router._policy:
            router.refresh(force=True)
        self._deadline = ambient or Deadline.after(router.request_timeout_s())
        self._policy = router.retry_policy()
        # Compose: an upstream response's value becomes the argument.
        resolved = []
        for arg in args:
            if isinstance(arg, DeploymentResponse):
                arg = await arg._result_async()
                if isinstance(arg, ResponseStream):
                    raise TypeError("a streaming deployment response cannot be composed into a "
                                    "downstream call")
            resolved.append(arg)
        self._args, self._kwargs = tuple(resolved), kwargs
        self._meta = RequestMetadata(method_name=handle._method_name,
                                     multiplexed_model_id=handle._model_id,
                                     session_id=handle._session_id)
        try:
            return await self._drive()
        except BaseException:
            self._finish_all(winner=None)
            raise

    # -- the attempts ---------------------------------------------------
    def _live(self) -> list[_Attempt]:
        return [a for a in self._attempts if not a.discarded]

    def _charged(self) -> int:
        """Attempts spent from the retry budget (moves off a draining or a
        shedding replica are free)."""
        return len(self._attempts) - self._drain_moves - self._shed_moves

    async def _launch_attempt(self, exclude: set | frozenset = frozenset(),
                              hedge: bool = False, now: bool = False) -> _Attempt:
        """Takes a slot on a replica and sends the request there. A hedge,
        or an attempt sent ``now``, takes a replica free now or none."""
        handle, router, meta = self._handle, self._router, self._meta
        affinity = handle._session_id or meta.multiplexed_model_id or handle._shape_key or None
        replica = await router.choose_replica(
            shape_key=handle._shape_key or None,
            deadline=Deadline.after(0.0) if hedge or now else self._deadline,
            exclude=exclude, affinity_key=affinity)
        number = len(self._attempts)
        # A replica that left the runtime since the pick fails the attempt as
        # a dead one does.
        call = router.call(
            replica, "handle_request",
            {"request_id": meta.request_id, "method_name": meta.method_name,
             "multiplexed_model_id": meta.multiplexed_model_id,
             "shape_key": handle._shape_key, "session_id": meta.session_id,
             "deadline_budget_s": self._deadline.budget(), "attempt": number,
             "trace_ctx": self._trace_ctx},
            self._args, self._kwargs)
        attempt = _Attempt(replica, asyncio.ensure_future(call), number, hedge)
        self._attempts.append(attempt)
        return attempt

    def _hedge_delay(self) -> float:
        if self._policy.hedge_after_s is not None:
            return max(0.0, self._policy.hedge_after_s)
        return self._router.observed_p95()

    async def _launch_hedge(self) -> None:
        self._hedged = True
        primary = {a.replica for a in self._live()}
        try:
            await self._launch_attempt(exclude=primary, hedge=True)
        except RuntimeError:
            # No spare replica: no hedge; the first attempt goes on.
            self._router.stats["hedges_skipped"] += 1
            metrics_mod.inc_serve_reliability("hedges", deployment=self._deployment,
                                              outcome="skipped")
            return
        self._router.stats["hedges_launched"] += 1
        metrics_mod.inc_serve_reliability("hedges", deployment=self._deployment,
                                          outcome="launched")

    async def _relaunch_or_raise(self, backoff: Backoff, cause: Optional[Exception]) -> None:
        """Sends the request to another replica within the retry budget, or
        raises the request's end."""
        last = self._attempts[-1].replica if self._attempts else "<none>"
        if self._charged() >= max(1, self._policy.max_attempts) or self._deadline.expired():
            raise ReplicaDiedError(
                self._deployment, last,
                f"retry budget exhausted after {self._charged()} attempt(s)") from cause
        await asyncio.sleep(backoff.next_delay(cap=self._deadline.remaining()))
        await self._launch_attempt(exclude={a.replica for a in self._attempts})
        self._router.stats["retries"] += 1
        metrics_mod.inc_serve_reliability("retries", deployment=self._deployment,
                                          reason="replica_death")

    async def _drive(self) -> Any:
        policy, deadline, router = self._policy, self._deadline, self._router
        backoff = Backoff(policy.initial_backoff_s, policy.max_backoff_s)
        hedge_after = self._hedge_delay() if policy.hedge else None
        await self._launch_attempt()
        cause: Optional[Exception] = None
        while True:
            live = self._live()
            if not live:
                await self._relaunch_or_raise(backoff, cause)
                continue
            if deadline.expired():
                metrics_mod.inc_serve_reliability("deadline_exceeded",
                                                  deployment=self._deployment)
                raise DeadlineExceededError(f"deadline expired waiting on {self._deployment!r}")
            waits = [deadline.remaining()]
            if (hedge_after is not None and not self._hedged and len(live) == 1
                    and len(self._attempts) < max(2, policy.max_attempts)):
                until_hedge = live[0].launched_at + hedge_after - time.monotonic()
                if until_hedge <= 0.0:
                    await self._launch_hedge()
                    live = self._live()
                else:
                    waits.append(until_hedge)
            timeout = min(waits)
            done, _ = await asyncio.wait([a.task for a in live],
                                         timeout=None if math.isinf(timeout) else timeout,
                                         return_when=asyncio.FIRST_COMPLETED)
            if not done:
                continue
            attempt = next(a for a in live if a.task in done)
            try:
                value = attempt.task.result()
            except _REPLICA_DEATH_ERRORS as exc:
                # The replica died with the attempt in flight.
                router.stats["attempt_deaths"] += 1
                self._discard(attempt)
                router.breaker(attempt.replica).record_failure()
                router.report_breaker(attempt.replica)
                router.drop_replica(attempt.replica)
                cause = exc
                continue
            except exceptions.TaskError as exc:
                kind = _remote_error_kind(exc)
                if kind == "ReplicaDrainingError":
                    # A deliberate drain: move without charging the budget
                    # or the breaker, a bounded number of times.
                    self._discard(attempt)
                    router.drop_replica(attempt.replica)
                    self._drain_moves += 1
                    if self._drain_moves > 8 or deadline.expired():
                        raise ReplicaDrainingError(attempt.replica) from exc
                    if not self._live():
                        await self._launch_attempt(exclude={a.replica for a in self._attempts})
                        metrics_mod.inc_serve_reliability(
                            "retries", deployment=self._deployment, reason="draining")
                    continue
                if kind == "RequestShedError":
                    # The replica is full now; the reference's handle ends
                    # the request here. An attempt still running may yet
                    # answer; else a replica not tried with room now takes it.
                    self._discard(attempt)
                    router.stats["attempts_shed"] += 1
                    if len(live) > 1:
                        continue
                    try:
                        await self._launch_attempt(
                            exclude={a.replica for a in self._attempts}, now=True)
                    except RuntimeError:
                        # The shedder's Retry-After estimate rides its message.
                        hint = re.search(r"retry_after_s=([0-9.]+)", str(exc))
                        raise RequestShedError(
                            f"replica of {self._deployment!r} shed the request",
                            retry_after_s=float(hint.group(1)) if hint else 1.0) from exc
                    self._shed_moves += 1
                    router.stats["shed_moves"] += 1
                    continue
                if kind == "DeadlineExceededError":
                    metrics_mod.inc_serve_reliability("deadline_exceeded",
                                                      deployment=self._deployment)
                    raise DeadlineExceededError(
                        f"deadline expired inside {self._deployment!r}") from exc
                raise
            router.breaker(attempt.replica).record_success()
            router.note_breaker(attempt.replica)
            if any(a.hedge for a in self._attempts):
                router.stats["hedges_won" if attempt.hedge else "hedges_lost"] += 1
                metrics_mod.inc_serve_reliability("hedges", deployment=self._deployment,
                                                  outcome="lost")
            self._finish_all(winner=attempt)
            if isinstance(value, dict) and "__serve_stream__" in value:
                # The stream keeps the router's slot until it ends.
                return ResponseStream(self, value["__serve_stream__"], attempt.replica, deadline)
            self._release(attempt)
            router.note_latency(time.monotonic() - attempt.launched_at)
            return value

    # -- slots ----------------------------------------------------------
    def _release(self, attempt: _Attempt) -> None:
        if not attempt.released:
            attempt.released = True
            self._router.on_request_done(attempt.replica)

    def _discard(self, attempt: _Attempt) -> None:
        attempt.discarded = True
        self._release(attempt)

    def _finish_all(self, winner: Optional[_Attempt]) -> None:
        """Settles every attempt but the winner: stops waiting for it, gives
        its slot back, and asks its replica to cancel it. The winner keeps
        its slot (a stream holds it to its end)."""
        for attempt in self._attempts:
            if attempt is winner or attempt.discarded:
                continue
            attempt.discarded = True
            attempt.task.cancel()
            self._release(attempt)
            cancel = asyncio.ensure_future(self._router.call(
                attempt.replica, "cancel_request", self._meta.request_id, attempt.number))
            _CANCELS.add(cancel)
            cancel.add_done_callback(_settle_cancel)


def _settle_cancel(task: asyncio.Task) -> None:
    """A lost attempt's cancel is best effort: its replica may be gone."""
    _CANCELS.discard(task)
    if not task.cancelled():
        task.exception()


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
                    self._router.call(self._replica, "stream_next", self._stream_id),
                    None if self._deadline.is_unbounded()
                    else max(0.05, self._deadline.remaining()))
            except _REPLICA_DEATH_ERRORS as exc:
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
                    self._router.call(self._replica, "stream_cancel", self._stream_id),
                    max(1.0, self._deadline.remaining(cap=10.0)))
            except (exceptions.RayTpuError, asyncio.TimeoutError):
                # The replica's reaper collects what is left.
                metrics_mod.inc_serve_reliability(
                    "stream_cancel_failures", deployment=self._response._deployment)

    def __next__(self):
        if not self._buffer:
            if self._done:
                self._raise_end()
            run_sync(self._fill())
            if not self._buffer:
                self._raise_end()
        return self._buffer.pop(0)

    def next_batch(self) -> list:
        return run_sync(self._next_batch())

    def cancel(self) -> None:
        run_sync(self._cancel())


class DeploymentHandle:
    """Calls a deployment: ``handle.remote(...)``, ``handle.method.remote(...)``
    or ``handle.options(method_name=...)``."""

    def __init__(self, deployment: str, app_name: str = "default"):
        self.deployment_name = deployment
        self.app_name = app_name
        self._router: Optional[Router] = None
        self._method_name = "__call__"
        self._model_id = ""
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
        """``multiplexed_model_id`` names the model the request runs (read in
        the replica by ``serve.get_multiplexed_model_id``); the ring sends a
        model's requests to the replica that holds it. ``shape_key`` labels
        the request's shape (a sequence bucket, say): such requests prefer
        replicas that already ran it. ``session_id`` is the ring's key above
        both."""
        clone = DeploymentHandle(self.deployment_name, self.app_name)
        # Option clones share one router, so their load counts agree.
        clone._router = self._get_router()
        clone._method_name = method_name or self._method_name
        clone._model_id = multiplexed_model_id or self._model_id
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
                                  self._model_id, self._shape_key, self._session_id))

    def __repr__(self):
        return f"DeploymentHandle({self.app_name}/{self.deployment_name})"


def _rebuild_handle(deployment, app_name, method_name, model_id="", shape_key="",
                    session_id=""):
    handle = DeploymentHandle(deployment, app_name)
    handle._method_name = method_name
    handle._model_id = model_id
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
