"""Atomic small-file writes — the tmp-then-rename idiom, shared.

Every small state/metadata file in the framework (checkpoint manifests,
snapshots, usage stats, experiment state, run records) must land
atomically: a crash mid-write may leave a stale file or a stray ``.tmp``,
but never a torn file at the final name. Readers either see the old
content or the new, complete content.

The tmp name carries the pid so concurrent writers (driver + train
workers sharing a session file) cannot clobber each other's in-flight
temp; the final ``os.replace`` is atomic within a filesystem.

``rtlint``'s ``non-atomic-write`` rule flags raw ``open(path, "w")``
writes in framework code — route them through these helpers instead.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any


def atomic_write_bytes(path: str, data: bytes, *, fsync: bool = False) -> None:
    """Write ``data`` to ``path`` via tmp + ``os.replace``.

    ``fsync=True`` additionally flushes the file to stable storage before
    the rename — use for commit markers whose loss would violate a
    durability protocol (checkpoint COMMIT files), not for best-effort
    telemetry.
    """
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        # rtlint: disable=blocking-in-async - sync-by-design durability primitive (write+fsync+rename); async callers write small metadata blobs where atomicity beats a thread hop
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # Never leave the temp behind on failure (ENOSPC, kill signal
        # unwinding): the torn content must not be mistaken for a
        # pending write by cleanup scanners.
        try:
            os.unlink(tmp)
        except OSError:  # rtlint: disable=swallowed-exception - tmp already renamed or never created
            pass
        raise


def atomic_write_text(path: str, text: str, *, fsync: bool = False) -> None:
    atomic_write_bytes(path, text.encode(), fsync=fsync)


def atomic_write_json(path: str, obj: Any, *, fsync: bool = False,
                      **dump_kwargs: Any) -> None:
    atomic_write_bytes(
        path, json.dumps(obj, **dump_kwargs).encode(), fsync=fsync
    )


def atomic_write_pickle(path: str, obj: Any, *, fsync: bool = False) -> None:
    atomic_write_bytes(path, pickle.dumps(obj), fsync=fsync)
