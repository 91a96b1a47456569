"""The comm plane's flight recorder and adaptive hang watchdog.

Port of ray_tpu's ``util/collective/flight.py``. Every collective op,
bucketed-overlap launch and fence, and ring send/recv appends a
fixed-size record to a per-process ring buffer:

    (group, kind, tag, seq, rank, peer, bytes,
     state enqueued -> launched -> completed, monotonic timestamps,
     trace_id)

so that when the ranks wedge, each can say what the last comm op on a
channel was and how long it has waited.

A per-channel watchdog turns the ring into live stall detection: a
channel's deadline adapts from a moving p95 of its completed ops
(``max(min_s, k * p95)``), so a uniformly slow run raises its own
deadlines instead of firing false positives, while one straggling rank
leaves its peers' recv records aging far past the channel's history. A
stall is kept in ``stall_events()`` and handed to the in-process stall
listeners (the compiled graphs' supervisor registers one).
``hang_doctor.build_report`` merges the ranks' rings into one verdict.

A stall also counts in ``rt_comm_stalls_total{group, channel}``, and the
watchdog sets the ``rt_comm_inflight`` and ``rt_comm_inflight_oldest_age_s``
gauges each tick (``util.metrics``), which a runtime process flushes to the
controller. Left out until ROADMAP Queue A item 14d: publishing a stall
event to the controller.

The hot path is a slot store into a preallocated ring addressed by
``next(itertools.count())`` (atomic under CPython) plus dict and deque
mutations that are each one bytecode-protected operation; only the
watchdog thread (4 Hz) snapshots.

Tuning knobs (env, read at recorder creation):

=============================================  =======  ==============
``RAY_TPU_COMM_FLIGHT``                        ``1``    ``0`` disables recording entirely
``RAY_TPU_COMM_FLIGHT_CAPACITY``               4096     ring slots per process
``RAY_TPU_COMM_WATCHDOG``                      ``1``    ``0`` records but never watches
``RAY_TPU_COMM_WATCHDOG_TICK_S``               0.25     scan period
``RAY_TPU_COMM_WATCHDOG_MIN_S``                2.0      deadline floor
``RAY_TPU_COMM_WATCHDOG_K``                    4.0      deadline = k * p95(channel)
``RAY_TPU_COMM_WATCHDOG_MIN_SAMPLES``          8        completions before the p95 arms
``RAY_TPU_COMM_WATCHDOG_STARTUP_S``            30.0     deadline while unarmed (cold compile grace)
``RAY_TPU_COMM_WATCHDOG_COOLDOWN_S``           5.0      per-channel re-fire suppression
=============================================  =======  ==============
"""

from __future__ import annotations

import collections
import itertools
import os
import re
import threading
import time
from typing import Any, Callable, Optional

_DIGITS = re.compile(r"\d+")

# record states
ENQUEUED = "enqueued"
LAUNCHED = "launched"
COMPLETED = "completed"
FAILED = "failed"


def channel_skeleton(tag: str) -> str:
    """Digit runs collapse to ``{}`` so per-step/per-microbatch tags
    (``s3.f2v1``, ``__barrier7/r0``, ``b4:12``) fold into one channel
    family — the same hole convention the static comm graph uses, letting a
    runtime channel be reconciled against the static graph."""
    return _DIGITS.sub("{}", tag or "")


def channel_id(group: str, kind: str, tag: str) -> str:
    return f"{group}:{kind}:{channel_skeleton(tag)}"


_site_tls = threading.local()


class site:
    """Context manager labeling records created on this thread with a
    call-site hint (the stage runner wraps its activation wire in
    ``flight.site("pipeline")`` so a hang report can say *which* wire)."""

    def __init__(self, label: str):
        self.label = label
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_site_tls, "value", None)
        _site_tls.value = self.label
        return self

    def __exit__(self, *exc):
        _site_tls.value = self._prev
        return False


def _current_site() -> Optional[str]:
    return getattr(_site_tls, "value", None)


_trace_tls = threading.local()


class trace:
    """Context manager stamping records created on this thread with a
    trace id: channel push/pop call sites wrap their flight-recorded
    ops, so the p2p records a channel's send/recv creates pick the
    ambient id up without the wire layer knowing about tracing."""

    def __init__(self, trace_id: Optional[str]):
        self.trace_id = trace_id
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_trace_tls, "value", None)
        _trace_tls.value = self.trace_id
        return self

    def __exit__(self, *exc):
        _trace_tls.value = self._prev
        return False


def _current_trace() -> Optional[str]:
    return getattr(_trace_tls, "value", None)


class CommRecord:
    """One fixed-shape ring entry. Mutated in place as the op advances
    (the inflight map and the ring share the object, so a snapshot sees
    the live state without any copy on the hot path)."""

    __slots__ = (
        "rid", "group", "kind", "tag", "seq", "rank", "world_size",
        "peer", "nbytes", "backend", "state", "t_wall", "t_enqueued",
        "t_launched", "t_completed", "trace_id", "site", "stalled",
    )

    def __init__(self, rid, group, kind, tag, seq, rank, world_size,
                 peer, nbytes, backend, now, wall):
        self.rid = rid
        self.group = group
        self.kind = kind
        self.tag = tag
        self.seq = seq
        self.rank = rank
        self.world_size = world_size
        self.peer = peer
        self.nbytes = nbytes
        self.backend = backend
        self.state = ENQUEUED
        self.t_wall = wall
        self.t_enqueued = now
        self.t_launched = 0.0
        self.t_completed = 0.0
        self.trace_id = _current_trace()
        self.site = _current_site()
        self.stalled = False

    @property
    def channel(self) -> str:
        return channel_id(self.group, self.kind, self.tag)

    def age_s(self, now: float) -> float:
        return now - self.t_enqueued

    def to_dict(self, now: Optional[float] = None) -> dict:
        out = {
            "rid": self.rid,
            "group": self.group,
            "kind": self.kind,
            "tag": self.tag,
            "channel": self.channel,
            "seq": self.seq,
            "rank": self.rank,
            "world_size": self.world_size,
            "peer": self.peer,
            "bytes": self.nbytes,
            "backend": self.backend,
            "state": self.state,
            "t_wall": self.t_wall,
            "trace_id": self.trace_id,
            "site": self.site,
            "stalled": self.stalled,
        }
        if self.state in (COMPLETED, FAILED):
            out["duration_s"] = max(0.0, self.t_completed - self.t_enqueued)
        elif now is not None:
            out["age_s"] = self.age_s(now)
        return out


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class FlightRecorder:
    """Per-process ring buffer + per-channel completion stats + watchdog.

    ``clock`` is injectable for deterministic watchdog unit tests."""

    def __init__(
        self,
        capacity: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        publish: Optional[Callable[[dict], None]] = None,
        start_watchdog: bool = True,
    ):
        self.capacity = int(
            capacity
            if capacity is not None
            else _env_f("RAY_TPU_COMM_FLIGHT_CAPACITY", 4096)
        )
        self.clock = clock
        self._ring: list[Optional[CommRecord]] = [None] * self.capacity
        self._idx = itertools.count()
        self._rid = itertools.count()
        # channel -> thread-safe monotonic per-channel sequence
        self._chan_seq: dict[str, Any] = {}
        # channel -> recent completed durations (moving p95 window)
        self._chan_stats: dict[str, collections.deque] = {}
        # rid -> live record; the watchdog's scan set
        self._inflight: dict[int, CommRecord] = {}
        self._stalls: list[dict] = []
        # Where a stall goes besides stall_events() and the listeners.
        self._publish = publish if publish is not None else _default_publish
        # watchdog tunables
        self.tick_s = _env_f("RAY_TPU_COMM_WATCHDOG_TICK_S", 0.25)
        self.min_deadline_s = _env_f("RAY_TPU_COMM_WATCHDOG_MIN_S", 2.0)
        self.k = _env_f("RAY_TPU_COMM_WATCHDOG_K", 4.0)
        self.min_samples = int(_env_f("RAY_TPU_COMM_WATCHDOG_MIN_SAMPLES", 8))
        self.startup_deadline_s = _env_f(
            "RAY_TPU_COMM_WATCHDOG_STARTUP_S", 30.0
        )
        self.cooldown_s = _env_f("RAY_TPU_COMM_WATCHDOG_COOLDOWN_S", 5.0)
        self._last_fire: dict[str, float] = {}
        self._watch_enabled = (
            start_watchdog
            and os.environ.get("RAY_TPU_COMM_WATCHDOG", "1") != "0"
        )
        self._watch_thread: Optional[threading.Thread] = None
        self._watch_lock = threading.Lock()

    # -- hot path --------------------------------------------------------
    def start(
        self,
        group: str,
        kind: str,
        tag: str = "",
        rank: int = 0,
        world_size: int = 1,
        peer: int = -1,
        nbytes: int = 0,
        backend: str = "",
        seq: Optional[int] = None,
    ) -> CommRecord:
        """Append an ``enqueued`` record and return it. ``seq`` defaults
        to the channel's own monotonic counter; p2p call sites pass the
        wire sequence so the record names the exact mailbox slot."""
        chan = channel_id(group, kind, tag)
        if seq is None:
            counter = self._chan_seq.get(chan)
            if counter is None:
                # setdefault is atomic; racing threads share one counter
                counter = self._chan_seq.setdefault(chan, itertools.count())
            seq = next(counter)
        rec = CommRecord(
            next(self._rid), group, kind, tag, seq, rank, world_size,
            peer, nbytes, backend, self.clock(), time.time(),
        )
        self._ring[next(self._idx) % self.capacity] = rec
        self._inflight[rec.rid] = rec
        self._ensure_watchdog()
        return rec

    def launched(self, rec: Optional[CommRecord]) -> None:
        if rec is not None and rec.state == ENQUEUED:
            rec.state = LAUNCHED
            rec.t_launched = self.clock()

    def completed(self, rec: Optional[CommRecord], ok: bool = True) -> None:
        if rec is None:
            return
        rec.t_completed = self.clock()
        rec.state = COMPLETED if ok else FAILED
        self._inflight.pop(rec.rid, None)
        if ok:
            stats = self._chan_stats.get(rec.channel)
            if stats is None:
                stats = self._chan_stats.setdefault(
                    rec.channel, collections.deque(maxlen=64)
                )
            stats.append(rec.t_completed - rec.t_enqueued)

    def note(self, group: str, kind: str, tag: str = "", **kw) -> CommRecord:
        """An instantaneous event (e.g. overlap launch): enqueued and
        completed in one append, still visible in the ring."""
        rec = self.start(group, kind, tag, **kw)
        self.completed(rec)
        return rec

    # -- read side -------------------------------------------------------
    def snapshot(self, last_n: int = 256) -> list[dict]:
        """Newest-last dicts of up to ``last_n`` ring entries. Reads the
        ring without draining it (a retried read returns the same
        records)."""
        now = self.clock()
        entries = [r for r in self._ring if r is not None]
        entries.sort(key=lambda r: r.rid)
        return [r.to_dict(now) for r in entries[-max(0, int(last_n)):]]

    def inflight_summary(self) -> dict:
        now = self.clock()
        recs = list(self._inflight.values())
        oldest = max((r.age_s(now) for r in recs), default=0.0)
        return {
            "count": len(recs),
            "oldest_age_s": oldest,
            "channels": sorted({r.channel for r in recs}),
        }

    def stall_events(self) -> list[dict]:
        return list(self._stalls)

    def stall_count(self) -> int:
        return len(self._stalls)

    # -- watchdog --------------------------------------------------------
    def deadline_s(self, channel: str) -> float:
        stats = self._chan_stats.get(channel)
        if stats is not None and len(stats) >= self.min_samples:
            durs = sorted(stats)
            idx = min(len(durs) - 1, int(round(0.95 * (len(durs) - 1))))
            return max(self.min_deadline_s, self.k * durs[idx])
        return max(self.min_deadline_s, self.startup_deadline_s)

    def check_once(self, now: Optional[float] = None) -> list[dict]:
        """One watchdog scan; returns the stall events fired this pass.
        Called by the watchdog thread each tick, and directly (with an
        injected clock) by deterministic tests."""
        now = self.clock() if now is None else now
        fired = []
        for rec in list(self._inflight.values()):
            if rec.stalled:
                continue
            deadline = self.deadline_s(rec.channel)
            age = rec.age_s(now)
            if age <= deadline:
                continue
            last = self._last_fire.get(rec.channel, -1e18)
            if now - last < self.cooldown_s:
                # Another record on this channel already fired recently;
                # mark it so the hang report still counts it as stalled.
                rec.stalled = True
                continue
            self._last_fire[rec.channel] = now
            rec.stalled = True
            event = rec.to_dict(now)
            event.update({
                "age_s": age,
                "deadline_s": deadline,
                "samples": len(self._chan_stats.get(rec.channel) or ()),
            })
            self._stalls.append(event)
            fired.append(event)
            try:
                self._publish(event)
            except Exception:  # publication is best effort: the ring holds the evidence
                pass
            _notify_stall_listeners(event)
        return fired

    def _ensure_watchdog(self) -> None:
        if not self._watch_enabled or self._watch_thread is not None:
            return
        with self._watch_lock:
            if self._watch_thread is not None:
                return
            thread = threading.Thread(
                target=self._watch_loop, name="comm-watchdog", daemon=True
            )
            self._watch_thread = thread
            thread.start()

    def _watch_loop(self) -> None:
        while True:
            time.sleep(self.tick_s)
            try:
                self.check_once()
                _export_inflight_gauge(self)
            except Exception:  # the watchdog outlives a failing scan
                pass


def _default_publish(event: dict) -> None:
    """A stall's metric: rt_comm_stalls_total{group, channel}."""
    from ray_tpu_torch.util import metrics

    metrics.record_comm_stall(event.get("group", "?"), event.get("channel", "?"))


def _export_inflight_gauge(rec: FlightRecorder) -> None:
    """rt_comm_inflight rides the metrics flush: the gauge is overwritten
    each tick (a snapshot, never drained), so a retried flush sends the
    same value again instead of losing it."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util import metrics

    summary = rec.inflight_summary()
    identity = (worker_mod.get_global_context().worker_id or "driver"
                if worker_mod.is_initialized() else "driver")
    metrics.set_comm_inflight(summary["count"], summary["oldest_age_s"], identity)


# ---------------------------------------------------------------------------
# in-process stall listeners (watchdog -> compiled-graph supervisor)
# ---------------------------------------------------------------------------
# A listener is (group_prefix, callback): the watchdog invokes the
# callback for every stall event whose group starts with the prefix. The
# compiled graphs' supervisor registers its dag_id here so a stall on any of the
# graph's channels (any recovery epoch — per-epoch group names share the
# dag_id prefix) wakes the blocked driver reader into an immediate
# liveness probe instead of waiting out its probe interval. Callbacks
# run on the watchdog thread and must not block.

_stall_listeners: list[tuple[str, Callable[[dict], None]]] = []


def register_stall_listener(prefix: str, cb: Callable[[dict], None]) -> None:
    _stall_listeners.append((prefix, cb))


def unregister_stall_listener(cb: Callable[[dict], None]) -> None:
    _stall_listeners[:] = [
        (p, c) for (p, c) in _stall_listeners if c is not cb
    ]


def _notify_stall_listeners(event: dict) -> None:
    group = str(event.get("group") or "")
    for prefix, cb in list(_stall_listeners):
        if group.startswith(prefix):
            try:
                cb(event)
            except Exception:  # a broken listener must not kill the watchdog
                pass


# ---------------------------------------------------------------------------
# module-level singleton facade (what the collective plane calls)
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def enabled() -> bool:
    return os.environ.get("RAY_TPU_COMM_FLIGHT", "1") != "0"


def get_recorder() -> FlightRecorder:
    global _recorder
    rec = _recorder
    if rec is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
            rec = _recorder
    return rec


def reset() -> None:
    """Forget the process recorder (tests)."""
    global _recorder
    with _recorder_lock:
        _recorder = None


def op_started(group, op, tag, rank, world_size, nbytes=0,
               backend="") -> Optional[CommRecord]:
    """One user-visible collective op begins (``_instrumented_outer``)."""
    if not enabled():
        return None
    rec = get_recorder().start(
        group, op, tag, rank=rank, world_size=world_size,
        nbytes=int(nbytes or 0), backend=backend,
    )
    rec.state = LAUNCHED
    rec.t_launched = rec.t_enqueued
    return rec


def p2p_started(group, direction, tag, seq, rank, peer, world_size,
                nbytes=0) -> Optional[CommRecord]:
    """A ring-wire send/recv begins; ``seq`` is the mailbox sequence, so
    the record names the exact ``(group, tag, seq)`` slot a hang report
    blames."""
    if not enabled():
        return None
    return get_recorder().start(
        group, direction, tag, rank=rank, world_size=world_size,
        peer=peer, nbytes=int(nbytes or 0), backend="ring", seq=seq,
    )


def launched(rec: Optional[CommRecord]) -> None:
    if rec is not None:
        get_recorder().launched(rec)


def completed(rec: Optional[CommRecord], ok: bool = True) -> None:
    if rec is not None:
        get_recorder().completed(rec, ok=ok)


def note(group, kind, tag="", **kw) -> Optional[CommRecord]:
    if not enabled():
        return None
    return get_recorder().note(group, kind, tag, **kw)


def snapshot(last_n: int = 256) -> list[dict]:
    if _recorder is None:
        return []
    return get_recorder().snapshot(last_n)


def inflight_summary() -> dict:
    if _recorder is None:
        return {"count": 0, "oldest_age_s": 0.0, "channels": []}
    return get_recorder().inflight_summary()


def stall_events() -> list[dict]:
    return [] if _recorder is None else get_recorder().stall_events()


def stall_count() -> int:
    return 0 if _recorder is None else get_recorder().stall_count()
