"""Build + load the native runtime library (libraytpu.so).

The port's copy of ray_tpu's ``_native/__init__.py``. The C++ sources are
the port's own copies under ``ray_tpu_torch/_native/src/`` (the engine
``rpc/transport.cc``, the store ``object_store/store.cc`` and the CPython
fast lane ``pyext/fastlane.cc``). They are compiled with g++ on first use
into ``build/ray_tpu_torch/native/`` beside the package (``.gitignore``
lists ``build/``), never into the package: each library's name carries a
hash of its sources and flags, so a changed source rebuilds, and processes
that start at once wait for one build under a file lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src")
_SRC_DIRS = [
    os.path.join(_SRC, "object_store"),
    os.path.join(_SRC, "rpc"),
]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "ray_tpu_torch", "native")
_LIB_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[str]:
    out: list[str] = []
    for d in _SRC_DIRS:
        if os.path.isdir(d):
            out.extend(
                os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".cc")
            )
    return out


def _digest(sources: list[str], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _compile(sources: list[str], flags: list[str], out: str) -> None:
    """g++ into a temporary file renamed onto ``out``: a process that loads
    ``out`` never sees a half-written library."""
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}_{threading.get_ident()}.tmp"
    cmd = ["g++", *flags, "-o", tmp, *sources]
    # Processes that start at once wait for one build instead of each
    # compiling the same sources.
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return
        try:
            # One-time build at first use, memoized on the sources' hash.
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed building {os.path.basename(out)}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _built(sources: list[str], flags: list[str], stem: str, force: bool) -> str:
    path = os.path.join(BUILD_DIR, f"{stem}_{_digest(sources, flags)}.so")
    if force and os.path.exists(path):
        os.unlink(path)
    if not os.path.exists(path):
        _compile(sources, flags, path)
    return path


def build(force: bool = False) -> str:
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no native sources found under {_SRC_DIRS}")
    return _built(sources, _LIB_FLAGS, "libraytpu", force)


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(path)
            lib.raytpu_store_start.restype = ctypes.c_void_p
            lib.raytpu_store_start.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ]
            lib.raytpu_store_stop.argtypes = [ctypes.c_void_p]
            # --- rpc transport (src/rpc/transport.cc) ---
            lib.rt_engine_new.restype = ctypes.c_void_p
            lib.rt_engine_stop.argtypes = [ctypes.c_void_p]
            lib.rt_notify_fd.argtypes = [ctypes.c_void_p]
            lib.rt_notify_fd.restype = ctypes.c_int
            lib.rt_connect_tcp.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.rt_connect_tcp.restype = ctypes.c_long
            lib.rt_connect_unix.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_connect_unix.restype = ctypes.c_long
            lib.rt_listen_tcp.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.rt_listen_tcp.restype = ctypes.c_long
            lib.rt_listen_unix.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_listen_unix.restype = ctypes.c_long
            lib.rt_next_msgid.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.rt_next_msgid.restype = ctypes.c_uint32
            lib.rt_send.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_uint8,
                ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_uint32,
            ]
            lib.rt_send.restype = ctypes.c_int
            lib.rt_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.rt_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.rt_next.restype = ctypes.c_int
            lib.rt_msg_free.argtypes = [ctypes.c_void_p]
            lib.rt_conn_debug.argtypes = [
                ctypes.c_void_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.rt_conn_debug.restype = ctypes.c_int
            # --- native call table + exec fast lane (hot path, N18-N20) ---
            lib.rt_call_start.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p,
                ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
            ]
            lib.rt_call_start.restype = ctypes.c_uint64
            lib.rt_call_start_buf.argtypes = lib.rt_call_start.argtypes
            lib.rt_call_start_buf.restype = ctypes.c_uint64
            lib.rt_send_buf.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_uint8,
                ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_uint32,
            ]
            lib.rt_send_buf.restype = ctypes.c_int
            lib.rt_exec_pending.argtypes = [ctypes.c_void_p]
            lib.rt_exec_pending.restype = ctypes.c_int
            lib.rt_conn_inflight.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.rt_conn_inflight.restype = ctypes.c_int
            lib.rt_call_wait.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.rt_call_wait.restype = ctypes.c_int
            lib.rt_call_poll.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
            ]
            lib.rt_call_poll.restype = ctypes.c_int
            lib.rt_call_abandon.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.rt_exec_filter.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_exec_next.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.rt_exec_next.restype = ctypes.c_int
            lib.rt_exec_inject.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.rt_list_conns.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_int,
            ]
            lib.rt_list_conns.restype = ctypes.c_int
            # --- object-transfer plane (push manager, N16) ---
            lib.rt_push_object.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p,
                ctypes.c_void_p, ctypes.c_uint64,
            ]
            lib.rt_push_object.restype = ctypes.c_int
            lib.rt_transfer_take.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.rt_transfer_take.restype = ctypes.c_int
            lib.rt_transfer_free.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
            ]
            # --- native lease lane (raylet grant path, N9/N10) ---
            lib.rt_lease_enable.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.rt_lease_adjust.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ]
            lib.rt_lease_adjust.restype = ctypes.c_int
            lib.rt_lease_pool_put.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_int,
            ]
            lib.rt_lease_pool_pop.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int,
            ]
            lib.rt_lease_pool_pop.restype = ctypes.c_int
            lib.rt_lease_pool_remove.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
            ]
            lib.rt_lease_pool_remove.restype = ctypes.c_int
            lib.rt_lease_worker_ban.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
            ]
            lib.rt_lease_worker_unban.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
            ]
            lib.rt_lease_forget.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_lease_forget.restype = ctypes.c_int
            lib.rt_lease_next_event.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.rt_lease_next_event.restype = ctypes.c_int
            lib.rt_lease_available_json.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.rt_lease_available_json.restype = ctypes.c_int
            lib.rt_lease_stats.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.rt_engine_stats.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ]
            _lib = lib
    return _lib


_pylib: "ctypes.PyDLL | None" = None


def load_nogilrelease() -> ctypes.PyDLL:
    """The same library loaded via PyDLL: calls KEEP the GIL.

    For microsecond-scale non-blocking entry points (rt_send on a
    non-blocking fd, rt_next, rt_next_msgid, rt_msg_free) the GIL
    release+reacquire of a normal CDLL call costs more than the call
    itself under thread contention (~150 us measured on a 1-core host vs
    ~10 us of actual work). Never use this handle for anything that can
    block."""
    global _pylib
    with _lock:
        if _pylib is None:
            path = build()
            lib = ctypes.PyDLL(path)
            lib.rt_send.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_uint8,
                ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_uint32,
            ]
            lib.rt_send.restype = ctypes.c_int
            lib.rt_next_msgid.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.rt_next_msgid.restype = ctypes.c_uint32
            lib.rt_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.rt_next.restype = ctypes.c_int
            lib.rt_msg_free.argtypes = [ctypes.c_void_p]
            # Non-blocking fast-lane entry points (safe to keep the GIL:
            # rt_call_start's inline send is on a non-blocking fd).
            lib.rt_call_start.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p,
                ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
            ]
            lib.rt_call_start.restype = ctypes.c_uint64
            lib.rt_call_start_buf.argtypes = lib.rt_call_start.argtypes
            lib.rt_call_start_buf.restype = ctypes.c_uint64
            lib.rt_send_buf.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_uint8,
                ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_uint32,
            ]
            lib.rt_send_buf.restype = ctypes.c_int
            lib.rt_exec_pending.argtypes = [ctypes.c_void_p]
            lib.rt_exec_pending.restype = ctypes.c_int
            lib.rt_conn_inflight.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.rt_conn_inflight.restype = ctypes.c_int
            lib.rt_call_poll.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
            ]
            lib.rt_call_poll.restype = ctypes.c_int
            lib.rt_call_abandon.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.rt_exec_inject.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            _pylib = lib
    return _pylib


# ---------------------------------------------------------------------------
# _fastlane — CPython extension for the per-task hot path (src/pyext/).
# Built separately from libraytpu.so (it needs Python headers); it attaches
# to the SAME engine library at runtime via dlopen, so the two stay one
# native runtime. Failure to build/load degrades to the ctypes path.
# ---------------------------------------------------------------------------
_FASTLANE_SRC = os.path.join(_SRC, "pyext", "fastlane.cc")
_fastlane_mod = None
_fastlane_failed = False
# Why the fast lane is off, when it is: the switch, or the build's or the
# import's error. None while it is on or not yet tried.
fastlane_off_reason: str | None = None


def build_fastlane(force: bool = False) -> str:
    import sysconfig

    flags = ["-std=c++17", "-O2", "-fPIC", "-shared", f"-I{sysconfig.get_paths()['include']}"]
    return _built([_FASTLANE_SRC], flags, "_fastlane", force)


def load_fastlane():
    """Import the _fastlane extension, attached to the engine lib.
    Returns the module, or None when disabled/unbuildable; then
    ``fastlane_off_reason`` says which."""
    global _fastlane_mod, _fastlane_failed, fastlane_off_reason
    if _fastlane_mod is not None:
        return _fastlane_mod
    if os.environ.get("RAY_TPU_fastlane") == "0":
        fastlane_off_reason = "RAY_TPU_fastlane=0"
        return None
    if _fastlane_failed:
        return None
    with _lock:
        if _fastlane_mod is not None:
            return _fastlane_mod
        try:
            import importlib.util

            lib_path = build()
            ext_path = build_fastlane()
            spec = importlib.util.spec_from_file_location(
                "ray_tpu_torch._native._fastlane", ext_path
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.attach(lib_path)
            _fastlane_mod = mod
        except Exception as exc:
            _fastlane_failed = True
            fastlane_off_reason = f"{type(exc).__name__}: {exc}"
            return None
    return _fastlane_mod


class RtMsgView(ctypes.Structure):
    """Mirror of rt_msg_view in src/rpc/transport.cc."""

    _fields_ = [
        ("conn", ctypes.c_long),
        ("kind", ctypes.c_uint8),
        ("msgid", ctypes.c_uint32),
        ("method", ctypes.c_void_p),
        ("mlen", ctypes.c_uint32),
        ("payload", ctypes.c_void_p),
        ("plen", ctypes.c_uint32),
        ("opaque", ctypes.c_void_p),
    ]
