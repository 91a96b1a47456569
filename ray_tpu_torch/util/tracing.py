"""Distributed tracing: OpenTelemetry-style spans without the SDK.

The port's copy of ray_tpu's ``util/tracing.py``. When
``RAY_TPU_tracing_enabled=1`` (``_private/config.py``), a request's work
is a causally linked tree of spans whose context (trace_id, span_id)
crosses processes: in the serve plane's request metadata (``trace_ctx``)
and the proxy's ``X-RayTPU-Trace`` header, in a compiled graph's shm
frame header (``pack_ctx``) and device-edge envelopes, in the serve-LLM
KV wire, and in a gang's function calls. Spans the port records:

  execute <fn>        gang member   one function a gang runs (``util/gang.py``)
  collective.<op>     any           a collective op (bytes, wire_bytes,
                                    comm_seq and comm_channel of its flight record)
  channel.push/pop    any           a compiled graph's or the KV wire's hop
  dag.stage <method>  actor         one stage invocation of a compiled graph
  serve.request       proxy         an HTTP request as the proxy sees it
  serve.replica       replica       a replica's handling of one request
  serve.prefill       decode        the prompt pass of a serve-LLM request
  serve.kv_transfer   decode        the KV payload's decode into the pool
  decode.iter         decode        one engine iteration of a sampled sequence

The exporter is a per-process JSONL file under
``<session_dir>/tracing/spans-<pid>.jsonl`` (the session directory from
``configure`` or ``RAYTPU_SESSION_DIR``), one span a line in the OTel
span JSON shape (name, trace_id, span_id, parent_id, start/end unix
nanoseconds, status, pid, attributes), byte for byte the reference's, so
each package reads the other's files. Writes are buffered and flushed in
batches (by age and size, and at exit). No span is recorded while tracing
is off, and none without a session directory.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import glob
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

from ray_tpu_torch._private.config import global_config

_current: contextvars.ContextVar[tuple[str, str] | None] = contextvars.ContextVar(
    "raytpu_trace_ctx", default=None
)
_lock = threading.Lock()       # guards _buffer / _flusher_started
_io_lock = threading.Lock()    # serializes file appends
_dir: str | None = None

# Buffered exporter: Span OBJECTS accumulate in a deque (append is
# atomic — no lock on the record path) and are serialized + appended in
# one batch by the flusher thread (age tick / atexit), so the hot path
# pays neither json.dumps nor a write() syscall nor a lock round-trip.
# Small per-task costs here are amplified by GIL contention with the io
# loop thread, so the record path must stay at "a few attribute stores
# and a deque append". The size cap is a memory backstop only — at
# steady state the 0.2s tick drains first.
_BUFFER_SPANS = 8192
_FLUSH_AGE_S = 0.2
_buffer: collections.deque = collections.deque()
_flusher_started = False

# Cheap span/trace ids: one urandom() per process (fork-safe via the pid
# key) + a counter, instead of two urandom syscalls per span. Same hex
# shapes as OTel ids: 16 chars for span_id, 32 for trace_id.
# _id_state = (pid, trace_prefix_16chars, span_prefix_8chars).
_id_state: tuple[int, str, str] | None = None
_id_counter = itertools.count(1)


def _id_prefixes() -> tuple[int, str, str]:
    global _id_state, _id_counter
    state = _id_state
    if state is None or state[0] != os.getpid():
        prefix = os.urandom(8).hex()
        state = _id_state = (os.getpid(), prefix, prefix[:8])
        _id_counter = itertools.count(1)
    return state


def _new_span_id() -> str:
    return f"{_id_prefixes()[2]}{next(_id_counter) & 0xFFFFFFFF:08x}"


def _new_trace_id() -> str:
    return f"{_id_prefixes()[1]}{next(_id_counter) & 0xFFFFFFFFFFFFFFFF:016x}"


def enabled() -> bool:
    return bool(getattr(global_config(), "tracing_enabled", False))


def configure(session_dir: str | None) -> None:
    """Set the export directory (driver: from init; workers: from env)."""
    global _dir
    if session_dir:
        # Drain any buffered spans into the PREVIOUS session's files so a
        # reconfigure (new init in the same process) never leaks old spans
        # into the new session dir.
        try:
            flush()
        except Exception:  # a flush into a dead previous session is best-effort
            pass
        _dir = os.path.join(session_dir, "tracing")


def _export_dir() -> str | None:
    # Memoize the env fallback (workers learn the session dir from the
    # environment): _record() runs per span and must not re-do an environ
    # lookup + path join each time.
    global _dir
    if _dir is None and "RAYTPU_SESSION_DIR" in os.environ:
        _dir = os.path.join(os.environ["RAYTPU_SESSION_DIR"], "tracing")
    return _dir


def _export_path() -> str | None:
    base = _export_dir()
    if base is None:
        return None
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, f"spans-{os.getpid()}.jsonl")


@dataclass(slots=True)
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    start_ns: int = 0
    end_ns: int = 0
    status: str = "ok"
    attributes: dict = field(default_factory=dict)

    def set_error(self, exc: BaseException | str) -> None:
        """Mark the span failed, recording the exception type."""
        self.status = "error"
        if isinstance(exc, BaseException):
            self.attributes["error_type"] = type(exc).__name__
            self.attributes.setdefault("error_message", str(exc)[:200])
        else:
            self.attributes["error_type"] = str(exc)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "status": self.status,
            "pid": _id_state[0] if _id_state else os.getpid(),
            "attributes": self.attributes,
        }


def flush() -> None:
    """Serialize + write every buffered span to the per-process file."""
    if not _buffer:
        return
    batch = []
    while True:
        try:
            batch.append(_buffer.popleft())
        except IndexError:
            break
    if not batch:
        return
    path = _export_path()
    if path is None:
        return
    # Hand-rolled JSON line: every field except name/attributes is an int
    # or hex id we generated, so json.dumps only runs on the two fields
    # that need escaping. ~2x faster than dumps(to_json()) per span, and
    # serialization time steals GIL slices from task execution even on
    # the flusher thread.
    pid = _id_state[0] if _id_state else os.getpid()
    dumps = json.dumps
    parts = []
    for rec in batch:
        parent = '"' + rec.parent_id + '"' if rec.parent_id else "null"
        parts.append(
            f'{{"name":{dumps(rec.name)},"trace_id":"{rec.trace_id}",'
            f'"span_id":"{rec.span_id}","parent_id":{parent},'
            f'"start_ns":{rec.start_ns},"end_ns":{rec.end_ns},'
            f'"status":"{rec.status}","pid":{pid},'
            f'"attributes":{dumps(rec.attributes, separators=(",", ":"))}}}\n'
        )
    lines = "".join(parts)
    with _io_lock:
        with open(path, "a") as fh:
            fh.write(lines)


def _flush_loop() -> None:
    while True:
        time.sleep(_FLUSH_AGE_S)
        try:
            flush()
        except Exception:
            # Keep the daemon alive; surface persistent write failures
            # when span-level debugging is on.
            logging.getLogger(__name__).debug(
                "trace flush failed", exc_info=True
            )


def _ensure_flusher() -> None:
    global _flusher_started
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True
    threading.Thread(
        target=_flush_loop, name="raytpu-span-flusher", daemon=True
    ).start()
    atexit.register(flush)


def _record(span: Span) -> None:
    if _export_dir() is None:
        return
    _buffer.append(span)  # deque append: atomic, no lock
    if not _flusher_started:
        _ensure_flusher()
    if len(_buffer) >= _BUFFER_SPANS:
        flush()  # memory backstop; the age tick normally drains first


def _parent_ctx(
    parent: tuple[str, str] | dict | None
) -> tuple[str, str] | None:
    if isinstance(parent, dict):
        return (parent["trace_id"], parent["span_id"])
    if parent is not None:
        return parent
    return _current.get()


@contextlib.contextmanager
def span(
    name: str,
    parent: tuple[str, str] | dict | None = None,
    **attributes: Any,
) -> Iterator[Span | None]:
    """Open a span. ``parent`` may be an injected dict from a TaskSpec, an
    explicit (trace_id, span_id) tuple, or None (inherit the contextvar /
    start a new trace). If the body raises, the span still sets ``end_ns``
    and flushes, with ``status: "error"`` + the exception type recorded."""
    if not enabled():
        yield None
        return
    parent_ctx = _parent_ctx(parent)
    trace_id = parent_ctx[0] if parent_ctx else _new_trace_id()
    record = Span(
        name=name,
        trace_id=trace_id,
        span_id=_new_span_id(),
        parent_id=parent_ctx[1] if parent_ctx else None,
        start_ns=time.time_ns(),
        attributes=attributes,
    )
    token = _current.set((trace_id, record.span_id))
    try:
        yield record
    except BaseException as exc:
        record.set_error(exc)
        raise
    finally:
        _current.reset(token)
        record.end_ns = time.time_ns()
        _record(record)


def emit(
    name: str,
    parent: tuple[str, str] | dict | None = None,
    *,
    start_ns: int,
    end_ns: int | None = None,
    status: str = "ok",
    **attributes: Any,
) -> Span | None:
    """Record a pre-timed span (for phases whose start predates the call
    site: controller lease parking, in-actor queue wait). Returns the
    recorded Span so callers can chain children off its span_id."""
    if not enabled():
        return None
    parent_ctx = _parent_ctx(parent)
    record = Span(
        name=name,
        trace_id=parent_ctx[0] if parent_ctx else _new_trace_id(),
        span_id=_new_span_id(),
        parent_id=parent_ctx[1] if parent_ctx else None,
        start_ns=start_ns,
        end_ns=end_ns if end_ns is not None else time.time_ns(),
        status=status,
        attributes=attributes,
    )
    _record(record)
    return record


def begin(
    name: str,
    parent: tuple[str, str] | dict | None = None,
    **attributes: Any,
) -> Span:
    """Hot-path span start: no contextmanager, no contextvar write.

    For per-task call sites (driver submit, worker execute) where the
    `span()` generator + contextvar round-trip is measurable at task
    rates. The caller embeds ``{"trace_id": s.trace_id, "span_id":
    s.span_id}`` wherever the context must ride and MUST call
    ``finish(s)`` on every path. Child spans name the parent explicitly,
    so skipping the contextvar loses nothing. The contextvar is still
    READ for parentage (a task submitted inside a traced actor method
    must chain), just never written. (Parent resolution is inlined:
    this path runs per task and every call costs ~3-8x its raw time in
    GIL handoffs with the io loop thread.)"""
    if type(parent) is dict:
        parent_ctx = (parent["trace_id"], parent["span_id"])
    elif parent is not None:
        parent_ctx = parent
    else:
        parent_ctx = _current.get()
    state = _id_prefixes()
    n = next(_id_counter)  # one draw serves both ids of a root span
    return Span(
        name=name,
        trace_id=(
            parent_ctx[0]
            if parent_ctx
            else f"{state[1]}{n & 0xFFFFFFFFFFFFFFFF:016x}"
        ),
        span_id=f"{state[2]}{n & 0xFFFFFFFF:08x}",
        parent_id=parent_ctx[1] if parent_ctx else None,
        start_ns=time.time_ns(),
        attributes=attributes,
    )


def finish(record: Span) -> None:
    """Close + record a span started with begin()."""
    record.end_ns = time.time_ns()
    _record(record)


def set_current(record: Span):
    """Make a begin()-span the ambient parent (returns a reset token).

    For hot-path spans that wrap USER code (worker execute): nested
    submits must chain off them, so the contextvar write span() does is
    needed — but the contextlib generator machinery is not."""
    return _current.set((record.trace_id, record.span_id))


def reset_current(token) -> None:
    _current.reset(token)


def inject() -> dict | None:
    """Current span context as a TaskSpec-embeddable dict."""
    if not enabled():
        return None
    ctx = _current.get()
    if ctx is None:
        return None
    return {"trace_id": ctx[0], "span_id": ctx[1]}


def context_of(record: Span | None) -> dict | None:
    """A specific span's context as an injectable dict (for hand-built
    parent/child links that bypass the contextvar)."""
    if record is None:
        return None
    return {"trace_id": record.trace_id, "span_id": record.span_id}


# -- compact wire context ---------------------------------------------------
# The compiled graphs' channel plane moves payloads with no RPC frame to ride, so the
# trace context crosses processes as a fixed 25-byte binary segment:
# 16-byte trace_id + 8-byte span_id + 1 flags byte (bit 0 = sampled).
# Hex round-trips exactly (ids are generated as 32/16 hex chars above).

CTX_WIRE_SIZE = 25
_FLAG_SAMPLED = 0x01


def pack_ctx(ctx: dict | tuple | None) -> bytes:
    """Encode an injected context for a channel frame header. Returns
    b"" for None (the disabled path writes zero extra bytes beyond the
    1-byte length that frames always carry)."""
    if ctx is None:
        return b""
    if isinstance(ctx, dict):
        trace_id, span_id = ctx["trace_id"], ctx["span_id"]
    else:
        trace_id, span_id = ctx
    try:
        return (
            bytes.fromhex(trace_id)
            + bytes.fromhex(span_id)
            + bytes([_FLAG_SAMPLED])
        )
    except ValueError:
        # Foreign-format ids (an OTLP bridge injecting its own): drop
        # rather than corrupt the frame.
        return b""


def unpack_ctx(buf) -> dict | None:
    """Decode a pack_ctx segment back to an injectable dict (None for
    empty/short segments)."""
    if not buf or len(buf) < CTX_WIRE_SIZE:
        return None
    b = bytes(buf[:CTX_WIRE_SIZE])
    return {
        "trace_id": b[:16].hex(),
        "span_id": b[16:24].hex(),
        "sampled": bool(b[24] & _FLAG_SAMPLED),
    }


def read_spans(session_dir: str) -> list[dict]:
    """All spans exported under a session (tests + dashboard route)."""
    flush()  # surface this process's buffered spans first
    out: list[dict] = []
    for path in sorted(
        glob.glob(os.path.join(session_dir, "tracing", "spans-*.jsonl"))
    ):
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        except OSError:
            continue
    return out
