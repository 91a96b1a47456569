"""Structured event export — lifecycle events as JSONL files.

Role-equivalent of the reference's event/export framework
(src/ray/util/event.cc :: RayEvent + export API protos, SURVEY §2.1 N28):
every control-plane lifecycle change (node added/removed, actor state,
placement-group state, job start/finish, task events) is appended as one
self-describing JSON line under ``<session_dir>/events/``, for external
platforms to tail — independent of the live pubsub channels, which only
reach connected subscribers.

Files rotate at ``event_export_max_bytes`` (one ``.1`` backup) so a
chatty cluster cannot grow them unboundedly.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

from ray_tpu_torch._private.config import global_config

# pubsub channel → export file stem
_CHANNEL_FILES = {
    "node_added": "node",
    "node_removed": "node",
    "actor_state": "actor",
    "pg_state": "placement_group",
    "job_started": "job",
    "job_finished": "job",
    "task_events": "task",
    # Trend-aware OOM early warning: the memory monitor saw a
    # worker's RSS slope projecting past the kill limit.
    "oom_risk": "oom_risk",
    # Comm watchdog suspected a stalled collective/p2p channel;
    # the controller follows up with a cluster-wide evidence harvest.
    "comm_stall": "comm_stall",
    # Step-profiler capture records: one per completed
    # (or failed) coordinated capture — manual CLI, straggler-triggered,
    # or comm-stall-triggered.
    "profile": "profile",
}


class EventExporter:
    """emit() is called from the controller's asyncio loop on every
    lifecycle broadcast — it only enqueues; a daemon writer thread does
    the disk I/O so a slow session-dir filesystem can never stall
    control-plane RPCs."""

    def __init__(self, session_dir: str):
        self.dir = os.path.join(session_dir, "events")
        self.enabled = global_config().event_export_enabled
        self._lock = threading.Lock()
        self._seq = 0
        self._queue: list[tuple[str, dict]] = []
        self._wake = threading.Event()
        self._writing = False
        self._writer: threading.Thread | None = None
        if self.enabled:
            os.makedirs(self.dir, exist_ok=True)

    def emit(self, source: str, payload: Any) -> None:
        if not self.enabled:
            return
        stem = _CHANNEL_FILES.get(source)
        if stem is None:
            return
        with self._lock:
            self._seq += 1
            record = {
                "event_id": f"{os.getpid():x}-{self._seq:08x}",
                "source_type": source,
                "timestamp": time.time(),
                "severity": "INFO",
                "data": payload,
            }
            self._queue.append((stem, record))
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name="event-export-writer",
                )
                self._writer.start()
        self._wake.set()

    def flush(self, timeout: float = 5.0) -> None:
        """Drain the queue synchronously (tests / shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue and not self._writing:
                    return
            self._wake.set()
            time.sleep(0.01)

    def _writer_loop(self) -> None:
        while True:
            self._wake.wait(timeout=1.0)
            self._wake.clear()
            with self._lock:
                batch, self._queue = self._queue, []
                self._writing = bool(batch)
            if not batch:
                continue
            # One open + one rotation check per stem per wakeup (a batch may
            # overshoot the rotation cap by its own size — bounded, fine).
            by_stem: dict[str, list[dict]] = {}
            for stem, record in batch:
                by_stem.setdefault(stem, []).append(record)
            for stem, records in by_stem.items():
                path = os.path.join(self.dir, f"events_{stem}.jsonl")
                self._rotate_if_needed(path)
                try:
                    with open(path, "a") as fh:
                        for record in records:
                            fh.write(json.dumps(record, default=str) + "\n")
                except OSError:
                    pass
            with self._lock:
                self._writing = False

    def _rotate_if_needed(self, path: str) -> None:
        cap = global_config().event_export_max_bytes
        try:
            if os.path.getsize(path) >= cap:
                os.replace(path, path + ".1")
        except OSError:
            pass


def read_events(session_dir: str, source: str | None = None) -> list[dict]:
    """Read exported events (newest file last); tests + dashboard route."""
    out: list[dict] = []
    events_dir = os.path.join(session_dir, "events")
    if not os.path.isdir(events_dir):
        return out
    names = sorted(os.listdir(events_dir))
    # backups first so ordering is oldest → newest
    for name in [n for n in names if n.endswith(".1")] + [
        n for n in names if n.endswith(".jsonl")
    ]:
        try:
            with open(os.path.join(events_dir, name)) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    record = json.loads(line)
                    if source is None or record.get("source_type") == source:
                        out.append(record)
        except OSError:
            continue
    return out
