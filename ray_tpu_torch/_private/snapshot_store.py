"""Pluggable controller persistence backends.

Role-equivalent of the reference's GCS store clients
(src/ray/gcs/store_client/ :: redis_store_client / in_memory_store_client
/ observable_store_client, SURVEY N7): the controller's snapshot logic
writes one opaque blob through a `SnapshotStore`; WHERE it lands is a
deployment choice:

  * ``file``  (default) — atomic write under the session dir; survives
    controller restarts, dies with the head disk.
  * ``memory`` — process-local; tests and throwaway clusters.
  * ``kv://host:port`` — an EXTERNAL wire-v1 KV endpoint (the standalone
    `python -m ray_tpu_torch._private.kv_store_server`, another cluster's
    controller, or anything speaking kv_put/kv_get). Head-disk loss no
    longer loses cluster state: restart the controller anywhere, point it
    at the same store, and it restores (the redis-HA deployment shape).

Selected via RAY_TPU_controller_store (config.controller_store).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

import msgpack

from ray_tpu_torch._private import atomic_io

_LEN = struct.Struct("<I")
_HDR = struct.Struct("<BBIH")  # ver, kind, msgid, method_len
_SNAPSHOT_NS = "controller_snapshots"
_SNAPSHOT_KEY = "state"


class SnapshotStore:
    # Save instrumentation (class defaults; first write creates instance
    # attrs). The scale suite reads these through controller_stats to
    # prove incremental snapshotting keeps write cost bounded.
    saves = 0
    save_bytes = 0
    save_ms_total = 0.0

    def save(self, blob: bytes) -> None:
        raise NotImplementedError

    def timed_save(self, blob: bytes) -> None:
        """save() plus bookkeeping — the controller's snapshot loop goes
        through here so every backend gets cost accounting for free."""
        start = time.perf_counter()
        self.save(blob)
        self.saves += 1
        self.save_bytes += len(blob)
        self.save_ms_total += (time.perf_counter() - start) * 1e3

    def stats(self) -> dict:
        return {
            "saves": self.saves,
            "bytes": self.save_bytes,
            "ms_total": round(self.save_ms_total, 3),
            "where": self.describe(),
        }

    def load(self) -> bytes | None:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class FileSnapshotStore(SnapshotStore):
    def __init__(self, path: str):
        self.path = path

    def save(self, blob: bytes) -> None:
        atomic_io.atomic_write_bytes(self.path, blob)

    def load(self) -> bytes | None:
        try:
            with open(self.path, "rb") as fh:
                return fh.read()
        except OSError:
            return None

    def describe(self) -> str:
        return f"file:{self.path}"


class MemorySnapshotStore(SnapshotStore):
    def __init__(self):
        self._blob: bytes | None = None

    def save(self, blob: bytes) -> None:
        self._blob = blob

    def load(self) -> bytes | None:
        return self._blob

    def describe(self) -> str:
        return "memory"


class _SyncWireClient:
    """Minimal BLOCKING wire-v1 client (same framing as the C++ client in
    cpp/src/client.cc): the store is consulted before the controller's
    io loop exists, so persistence cannot ride the asyncio RPC stack."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: socket.socket | None = None
        self._msgid = 0
        self._lock = threading.Lock()

    def _connect(self) -> None:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            chunk = self._sock.recv(n)
            if not chunk:
                raise ConnectionError("kv store connection closed")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def call(self, method: str, payload: dict) -> dict:
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    self._msgid += 1
                    body = _HDR.pack(1, 0, self._msgid, len(method))
                    body += method.encode()
                    body += msgpack.packb(payload, use_bin_type=True)
                    self._sock.sendall(_LEN.pack(len(body)) + body)
                    while True:
                        (length,) = _LEN.unpack(self._recv_exact(4))
                        frame = self._recv_exact(length)
                        _ver, kind, msgid, mlen = _HDR.unpack_from(frame, 0)
                        if msgid != self._msgid:
                            continue  # stale/push frame
                        raw = frame[8 + mlen:]
                        reply = (
                            msgpack.unpackb(raw, raw=False) if raw else None
                        )
                        if kind == 2:  # ERR
                            raise RuntimeError(f"kv store error: {reply}")
                        return reply
                except (OSError, ConnectionError):
                    self._sock = None
                    if attempt:
                        raise
        raise ConnectionError("unreachable")


class ExternalKVSnapshotStore(SnapshotStore):
    """Snapshots in an external wire-v1 KV service (redis_store_client
    role). The key is scoped by CLUSTER (session id), so several
    clusters may share one KV endpoint without clobbering each other —
    and a fresh cluster never restores a dead cluster's state. Failures
    raise so the snapshot loop keeps the dirty bit (and boot treats an
    unreachable store as fatal, not empty)."""

    def __init__(self, host: str, port: int, scope: str):
        self._client = _SyncWireClient(host, port)
        self._key = f"{_SNAPSHOT_KEY}:{scope}"
        self._where = f"kv://{host}:{port}/{self._key}"

    def save(self, blob: bytes) -> None:
        reply = self._client.call(
            "kv_put",
            {
                "namespace": _SNAPSHOT_NS,
                "key": self._key,
                "value": blob,
                "overwrite": True,
            },
        )
        if not reply or reply.get("status") != "ok":
            raise RuntimeError(f"external snapshot save failed: {reply}")

    def load(self) -> bytes | None:
        reply = self._client.call(
            "kv_get", {"namespace": _SNAPSHOT_NS, "key": self._key}
        )
        if not reply:
            raise ConnectionError("external snapshot load: empty reply")
        if reply.get("status") != "ok":
            return None  # missing key: genuinely no snapshot for scope
        return reply.get("value")

    def describe(self) -> str:
        return self._where


def make_store(spec: str, session_dir: str) -> SnapshotStore:
    spec = (spec or "file").strip()
    if spec in ("", "file"):
        return FileSnapshotStore(
            os.path.join(session_dir, "controller_state.json")
        )
    if spec == "memory":
        return MemorySnapshotStore()
    if spec.startswith("kv://"):
        hostport = spec[len("kv://"):]
        host, _, port = hostport.rpartition(":")
        scope = os.path.basename(os.path.normpath(session_dir))
        return ExternalKVSnapshotStore(
            host or "127.0.0.1", int(port), scope
        )
    raise ValueError(f"unknown controller store spec {spec!r}")
