"""Deterministic chaos injection: the fault plane's decision engine.

The port's copy of ray_tpu's ``_private/chaos.py``. A seeded
:class:`FaultSchedule` says which faults to inject:

  * drop / delay / duplicate / reorder single RPC messages,
  * asymmetric node-pair partitions on a shared timeline,
  * per-process slowdowns,
  * named fail points inside subsystems (``failpoint``), armed for a
    number of hits or inside an epoch-relative window,
  * named latency points (``latency_delay``), always or in a window, and
  * scheduled kills, as data (the reference's ``ChaosMonkey`` executes
    them against a cluster; the port's waits for ROADMAP Queue A item 14c).

Every per-message decision is a pure function of ``(seed, decision
point, method, per-point counter)`` through SHA-256, with no shared RNG
stream, so two runs that issue the same logical sequence of calls take the
same faults, and every decision that fires is appended to a per-process
JSONL event log. The decisions and the log lines are the reference's for
the same schedule and calls. The message-level hooks have no caller in the
port until its RPC layer (ROADMAP Queue A item 14b); the fail and latency
points are wired into the ported modules.

Config sources, in precedence order:
  1. programmatic :func:`install` (also exports to the environment so the
     processes started afterwards inherit the schedule),
  2. ``RAY_TPU_chaos``: a JSON object or ``@/path/to/file``,
  3. legacy ``RAY_TPU_testing_rpc_delay_ms``: an alias for a delay-only
     schedule (deprecated; use ``{"delay_ms": N}``).
"""

from __future__ import annotations

import asyncio
import fnmatch
import hashlib
import json
import os
import threading
import time
from typing import Any

from ray_tpu_torch._private.config import global_config

_ENV_SCHEDULE = "RAY_TPU_chaos"
_ENV_IDENTITY = "RAY_TPU_chaos_identity"
_ENV_LOG_DIR = "RAY_TPU_chaos_log_dir"

# Data-plane methods excluded from message-level faults by default: their
# delivery contracts (at-most-once actor calls, streaming object chunks)
# have their own recovery machinery and schedules opt in explicitly.
DEFAULT_EXCLUDE = (
    "push_task",
    "push_actor_task",
    "stream_next",
    "stream_cancel",
    "pull_object_chunk",
    "push_object",
    "obj_chunk",
    "register_worker",
)

# Methods the chaos-aware retry loop must never re-send on timeout: a
# retry would violate at-most-once semantics (these are excluded from
# faults by default anyway, but a user schedule may include them).
NON_RETRYABLE = ("push_actor_task", "push_task")


class ChaosFault(Exception):
    """Raised by an armed fail-point (see FaultSchedule.fail_points)."""


class FaultSchedule:
    """Declarative, seed-reproducible fault schedule.

    Message-fault probabilities are per-RPC and evaluated independently at
    each decision point; ``partitions`` / ``slow`` entries live on a shared
    timeline anchored at ``epoch`` (unix time, set once by whoever creates
    the schedule and inherited by every cluster process).
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        drop_request: float = 0.0,
        drop_reply: float = 0.0,
        dup_request: float = 0.0,
        dup_reply: float = 0.0,
        delay_ms: float = 0.0,
        delay_jitter_ms: float = 0.0,
        reorder: float = 0.0,
        reorder_ms: float = 50.0,
        methods: list[str] | None = None,
        exclude_methods: list[str] | None = None,
        partitions: list[dict] | None = None,
        slow: list[dict] | None = None,
        fail_points: dict[str, int] | None = None,
        latency_points: dict[str, float] | None = None,
        kills: list[dict] | None = None,
        call_timeout_s: float = 2.0,
        max_call_attempts: int = 6,
        epoch: float | None = None,
    ):
        self.seed = int(seed)
        self.drop_request = float(drop_request)
        self.drop_reply = float(drop_reply)
        self.dup_request = float(dup_request)
        self.dup_reply = float(dup_reply)
        self.delay_ms = float(delay_ms)
        self.delay_jitter_ms = float(delay_jitter_ms)
        self.reorder = float(reorder)
        self.reorder_ms = float(reorder_ms)
        self.methods = list(methods) if methods else []
        self.exclude_methods = (
            list(exclude_methods)
            if exclude_methods is not None
            else list(DEFAULT_EXCLUDE)
        )
        # [{"src": "node:*", "dst": "controller", "start_s": 2, "duration_s": 10}]
        self.partitions = list(partitions or [])
        # [{"match": "node:abc*", "extra_ms": 50}]
        self.slow = list(slow or [])
        # {"controller.snapshot_save": 2} -> first 2 hits raise ChaosFault.
        # A value may also be {"count": N, "start_s": X, "duration_s": Y}:
        # armed only inside the epoch-relative window (count -1 = every hit
        # in the window). Windows bound process-kill fail points — a
        # replacement process gets a fresh per-process budget, so an
        # unwindowed kill point would fell every successor too.
        self.fail_points = dict(fail_points or {})
        # {"serve.replica.request": 500.0} -> callers of latency_delay()
        # at that point sleep the given extra milliseconds (slow-replica /
        # tail-latency injection). Always-on while armed, unlike
        # fail_points there is no hit budget — slowness is a condition,
        # not an event. A value may also be the windowed dict form
        # {"extra_ms": X, "start_s": S, "duration_s": D} (epoch-relative,
        # like fail_points): the hang-doctor chaos gate uses it to wedge
        # exactly one rank's allreduce for a bounded window.
        self.latency_points = dict(latency_points or {})
        # [{"at_s": 3, "target": "controller"|"agent:<idx>"|"worker:<idx>",
        #   "restart_after_s": 2.0}] — executed by ChaosMonkey, not here.
        self.kills = list(kills or [])
        self.call_timeout_s = float(call_timeout_s)
        self.max_call_attempts = int(max_call_attempts)
        self.epoch = float(epoch) if epoch is not None else time.time()

    # -- (de)serialization ------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({k: v for k, v in vars(self).items()})

    @classmethod
    def from_json(cls, raw: str) -> "FaultSchedule":
        data = json.loads(raw)
        seed = data.pop("seed", 0)
        known = {
            k: v for k, v in data.items()
            if k in cls(0).__dict__  # ignore unknown keys (fwd compat)
        }
        return cls(seed, **known)

    def message_faults_enabled(self) -> bool:
        return any(
            p > 0
            for p in (
                self.drop_request, self.drop_reply, self.dup_request,
                self.dup_reply, self.reorder,
            )
        ) or self.delay_ms > 0 or self.delay_jitter_ms > 0

    def lossy(self) -> bool:
        """True when messages can vanish outright (drops or partitions) —
        only then do calls need the chaos timeout cap + retry loop; a
        delay/dup-only schedule keeps the caller's own timeout semantics."""
        return (
            self.drop_request > 0
            or self.drop_reply > 0
            or bool(self.partitions)
        )

    def targets(self, method: str) -> bool:
        if self.methods:
            return any(fnmatch.fnmatch(method, m) for m in self.methods)
        return not any(
            fnmatch.fnmatch(method, m) for m in self.exclude_methods
        )


class ChaosInjector:
    """Per-process fault decision engine + event log.

    Decisions are derived per decision point from
    ``sha256(seed | point | method | n)`` where ``n`` counts prior
    decisions at that (point, method) in this process — deterministic
    given the same logical call sequence, independent across points.
    """

    def __init__(
        self,
        schedule: FaultSchedule | None,
        identity: str | None = None,
        log_dir: str | None = None,
    ):
        self.schedule = schedule
        self.identity = identity or os.environ.get(
            _ENV_IDENTITY, f"pid:{os.getpid()}"
        )
        self._counters: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self.events: list[dict] = []
        self._log_fh = None
        log_dir = log_dir or os.environ.get(_ENV_LOG_DIR)
        if schedule is not None and log_dir:
            try:
                os.makedirs(log_dir, exist_ok=True)
                safe = self.identity.replace("/", "_").replace(":", "_")
                self._log_fh = open(
                    os.path.join(log_dir, f"chaos-{safe}-{os.getpid()}.jsonl"),
                    "a",
                    buffering=1,
                )
            except OSError:
                self._log_fh = None
        self._fail_point_hits: dict[str, int] = {}

    # -- state ------------------------------------------------------------
    @property
    def active(self) -> bool:
        return self.schedule is not None

    def elapsed(self) -> float:
        return time.time() - self.schedule.epoch if self.schedule else 0.0

    # -- deterministic decisions ------------------------------------------
    def _roll(self, point: str, method: str) -> tuple[float, int]:
        """A uniform [0,1) draw, pure in (seed, point, method, n)."""
        with self._lock:
            n = self._counters.get((point, method), 0)
            self._counters[(point, method)] = n + 1
        digest = hashlib.sha256(
            f"{self.schedule.seed}|{point}|{method}|{n}".encode()
        ).digest()
        return int.from_bytes(digest[:8], "big") / 2**64, n

    def _record(self, point: str, method: str, n: int, action: str,
                **detail) -> None:
        event = {
            "t": round(self.elapsed(), 4),
            "id": self.identity,
            "point": point,
            "method": method,
            "n": n,
            "action": action,
        }
        if detail:
            event.update(detail)
        self.events.append(event)
        if self._log_fh is not None:
            try:
                self._log_fh.write(json.dumps(event) + "\n")
            except OSError:
                pass

    # -- partitions / slowdowns -------------------------------------------
    def partitioned(self, peer: str | None) -> bool:
        """True while an active partition blocks identity -> peer."""
        if not self.schedule or not self.schedule.partitions:
            return False
        now = self.elapsed()
        for part in self.schedule.partitions:
            start = float(part.get("start_s", 0.0))
            duration = float(part.get("duration_s", 0.0))
            if not (start <= now < start + duration):
                continue
            src_ok = fnmatch.fnmatch(self.identity, part.get("src", "*"))
            dst_ok = peer is not None and fnmatch.fnmatch(
                peer, part.get("dst", "*")
            )
            if src_ok and dst_ok:
                return True
            if part.get("symmetric") and peer is not None:
                if fnmatch.fnmatch(self.identity, part.get("dst", "*")) and \
                        fnmatch.fnmatch(peer, part.get("src", "*")):
                    return True
        return False

    def _slow_extra_ms(self) -> float:
        if not self.schedule or not self.schedule.slow:
            return 0.0
        return sum(
            float(entry.get("extra_ms", 0.0))
            for entry in self.schedule.slow
            if fnmatch.fnmatch(self.identity, entry.get("match", "*"))
        )

    # -- transport hooks ---------------------------------------------------
    async def on_client_send(self, method: str, peer: str | None) -> str:
        """Consulted by both RPC client backends before writing a request
        frame. Sleeps any injected delay; returns "send" or "drop"."""
        schedule = self.schedule
        if schedule is None:
            return "send"
        if self.partitioned(peer):
            # Events are recorded under their ROLL point so the
            # (id, point, method, n) coordinate is unique per decision.
            _, n = self._roll("partition", method)
            self._record("partition", method, n, "partition", peer=peer)
            return "drop"
        if not schedule.targets(method):
            await self._base_delay()
            return "send"
        delay_ms = schedule.delay_ms + self._slow_extra_ms()
        if schedule.delay_jitter_ms > 0:
            jitter, _ = self._roll("delay", method)
            delay_ms += jitter * schedule.delay_jitter_ms
        if schedule.reorder > 0:
            roll, n = self._roll("reorder", method)
            if roll < schedule.reorder:
                # TCP delivers in order per connection; "reorder" = hold
                # this message long enough for later sends to overtake it.
                self._record("reorder", method, n, "reorder")
                delay_ms += schedule.reorder_ms
        if delay_ms > 0:
            await asyncio.sleep(delay_ms / 1000.0)
        roll, n = self._roll("drop_request", method)
        if roll < schedule.drop_request:
            self._record("drop_request", method, n, "drop")
            return "drop"
        return "send"

    async def on_server_request(self, method: str) -> str:
        """Consulted at server dispatch. Returns "dispatch" or "dup"
        (handler deliberately applied twice — the idempotency probe)."""
        schedule = self.schedule
        if schedule is None or not schedule.targets(method):
            return "dispatch"
        roll, n = self._roll("dup_request", method)
        if roll < schedule.dup_request:
            self._record("dup_request", method, n, "dup")
            return "dup"
        return "dispatch"

    async def on_server_reply(self, method: str) -> str:
        """Consulted after the handler ran, before the REP frame is
        written. Returns "send", "drop" (reply lost after the mutation
        applied — the case idempotency tokens exist for) or "dup"."""
        schedule = self.schedule
        if schedule is None or not schedule.targets(method):
            return "send"
        roll, n = self._roll("drop_reply", method)
        if roll < schedule.drop_reply:
            self._record("drop_reply", method, n, "drop")
            return "drop"
        roll, n = self._roll("dup_reply", method)
        if roll < schedule.dup_reply:
            self._record("dup_reply", method, n, "dup")
            return "dup"
        return "send"

    async def _base_delay(self) -> None:
        extra = self._slow_extra_ms()
        if extra > 0:
            await asyncio.sleep(extra / 1000.0)

    # -- chaos-aware call policy ------------------------------------------
    def effective_timeout(self, method: str, timeout: float | None):
        """Cap per-attempt wait so dropped messages surface as timeouts
        instead of hanging the caller forever. Only applies to lossy
        schedules; dups/delays keep the caller's own timeout."""
        if self.schedule is None or not self.schedule.lossy():
            return timeout
        if not self.schedule.targets(method):
            return timeout
        if timeout is None:
            return self.schedule.call_timeout_s
        return min(timeout, self.schedule.call_timeout_s)

    def max_attempts(self, method: str) -> int:
        if self.schedule is None or not self.schedule.lossy():
            return 1
        if not self.schedule.targets(method):
            return 1
        if any(fnmatch.fnmatch(method, m) for m in NON_RETRYABLE):
            return 1
        return max(1, self.schedule.max_call_attempts)

    # -- fail points -------------------------------------------------------
    def failpoint(self, point: str) -> None:
        """Raise ChaosFault while the named fail-point is armed. A count
        of N arms the first N hits; -1 arms it forever."""
        schedule = self.schedule
        if schedule is None:
            return
        budget = schedule.fail_points.get(point)
        if not budget:
            return
        if isinstance(budget, dict):
            now = self.elapsed()
            start = float(budget.get("start_s", 0.0))
            duration = float(budget.get("duration_s", float("inf")))
            if not (start <= now < start + duration):
                return
            budget = int(budget.get("count", -1))
            if not budget:
                return
        hits = self._fail_point_hits.get(point, 0)
        if budget > 0 and hits >= budget:
            return
        self._fail_point_hits[point] = hits + 1
        self._record("failpoint", point, hits, "fail")
        raise ChaosFault(f"injected fault at {point} (hit {hits + 1})")

    def latency_delay(self, point: str) -> float:
        """Extra seconds to sleep at the named latency point (0.0 when
        unarmed). Returns the delay instead of sleeping so async callers
        can await it and sync callers can time.sleep it."""
        schedule = self.schedule
        if schedule is None:
            return 0.0
        extra_ms = schedule.latency_points.get(point, 0.0)
        if isinstance(extra_ms, dict):
            now = self.elapsed()
            start = float(extra_ms.get("start_s", 0.0))
            duration = float(extra_ms.get("duration_s", float("inf")))
            if not (start <= now < start + duration):
                return 0.0
            extra_ms = float(extra_ms.get("extra_ms", 0.0))
        if extra_ms <= 0:
            return 0.0
        self._record("latency_point", point, 0, f"{extra_ms}ms")
        return extra_ms / 1000.0

    def close(self) -> None:
        if self._log_fh is not None:
            try:
                self._log_fh.close()
            except OSError:
                pass
            self._log_fh = None


# ---------------------------------------------------------------------------
# process-wide singleton
# ---------------------------------------------------------------------------
_injector: ChaosInjector | None = None
_injector_lock = threading.Lock()
_NULL = ChaosInjector(None)  # shared inactive injector (zero-alloc fast path)


def _schedule_from_env() -> FaultSchedule | None:
    raw = os.environ.get(_ENV_SCHEDULE)
    if raw:
        if raw.startswith("@"):
            try:
                with open(raw[1:]) as fh:
                    raw = fh.read()
            except OSError:
                return None
        try:
            return FaultSchedule.from_json(raw)
        except (ValueError, TypeError):
            return None
    # Deprecated alias: a bare uniform RPC delay rides the chaos plane now.
    delay_ms = global_config().testing_rpc_delay_ms
    if delay_ms:
        return FaultSchedule(0, delay_ms=float(delay_ms))
    return None


def get_injector() -> ChaosInjector:
    global _injector
    injector = _injector
    if injector is None:
        with _injector_lock:
            if _injector is None:
                schedule = _schedule_from_env()
                _injector = (
                    ChaosInjector(schedule) if schedule is not None else _NULL
                )
            injector = _injector
    return injector


def install(
    schedule: FaultSchedule | None,
    identity: str | None = None,
    log_dir: str | None = None,
    export_env: bool = True,
) -> ChaosInjector:
    """Install a schedule in THIS process and (by default) export it to
    the environment so cluster subprocesses spawned afterwards inherit
    it. Pass ``schedule=None`` to uninstall."""
    global _injector
    with _injector_lock:
        if _injector is not None:
            _injector.close()
        if export_env:
            if schedule is None:
                os.environ.pop(_ENV_SCHEDULE, None)
                os.environ.pop(_ENV_LOG_DIR, None)
            else:
                os.environ[_ENV_SCHEDULE] = schedule.to_json()
                if log_dir:
                    os.environ[_ENV_LOG_DIR] = log_dir
        _injector = (
            ChaosInjector(schedule, identity=identity, log_dir=log_dir)
            if schedule is not None
            else _NULL
        )
        return _injector


def set_identity(identity: str) -> None:
    """Label this process for partition matching / event attribution
    (controller calls with "controller", agents with "node:<id>", ...).
    Takes effect for the current injector and any future one."""
    os.environ[_ENV_IDENTITY] = identity
    injector = get_injector()
    injector.identity = identity


def reset() -> None:
    """Forget the installed/env-derived injector (tests)."""
    global _injector
    with _injector_lock:
        if _injector is not None:
            _injector.close()
        _injector = None


def failpoint(point: str) -> None:
    """Module-level convenience: subsystems call ``chaos.failpoint(name)``
    at interesting internal boundaries; a no-op unless armed."""
    get_injector().failpoint(point)


def latency_delay(point: str) -> float:
    """Module-level convenience for latency injection points: extra
    seconds to sleep here (0.0 unless armed)."""
    return get_injector().latency_delay(point)
