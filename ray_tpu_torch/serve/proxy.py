"""HTTP proxy: the ingress, an HTTP/1.1 server on stdlib asyncio streams.

Port of ray_tpu's ``serve/_private/proxy.py`` (which runs aiohttp; the
port depends on no HTTP library). Each proxy is a detached actor
(``SERVE_PROXY::<port>``, ``max_concurrency=64``) that serves on its
process's serve I/O loop beside the handles it calls, so a request costs
no thread hop: the route table comes from the membership snapshot, the
longest matching
``route_prefix`` names the ingress deployment, and its handle is awaited
on the loop. The reference's behaviour is kept: JSON bodies (a body that
is not JSON passes as bytes; a GET passes its query as a dict), replies in
JSON unless the deployment returns bytes or a str, ``/-/healthz`` and
``/-/routes``, 404 ``no route for <path>``, 500 ``<Type>: <message>``, 503
with Retry-After when the route's in-flight requests reach its admission
limit, 504 ``deadline exceeded: ...``, the ``X-RayTPU-Deadline`` ingress
header, and generator deployments streamed as SSE (``data: <item>`` lines
under ``Accept: text/event-stream``) or as newline-delimited chunks.
Connections are kept alive (HTTP/1.1), and every reply but a stream
carries its Content-Length; streams use chunked transfer encoding.

Each route keeps a latency histogram and an error count
(``get_route_stats``: count, p50, p95, p99, mean, max, errors), which the
controller scrapes for the autoscaler, with the requests of each route it
holds now; a stream counts its time to the first dispatch. Every answer feeds ``util/metrics``'s request series, and
every shed its reliability counter. An armed ``serve.proxy.kill`` ends
the proxy's process and the controller restarts the actor on its port.
The flush of the route stats to the controller's workload store waits
for ROADMAP Queue A item 14d.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import json
import os
import time
import traceback
from http import HTTPStatus
from typing import Any, Optional
from urllib.parse import parse_qsl, urlsplit

from ray_tpu_torch._private import chaos
from ray_tpu_torch.serve._common import (
    DEADLINE_HEADER, Deadline, LatencyHistogram, RequestShedError,
)
from ray_tpu_torch.serve.handle import (
    DeploymentHandle, DeploymentResponse, ResponseStream, run_sync,
)
from ray_tpu_torch.serve.long_poll import get_subscriber
from ray_tpu_torch.serve.routing import match_route
from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util import tracing

_TEXT = "text/plain; charset=utf-8"
_JSON = "application/json; charset=utf-8"
# The largest request body, and the most header lines, the proxy reads.
MAX_BODY_BYTES = 64 << 20
MAX_HEADERS = 100


class _BadRequest(Exception):
    pass


def parse_deadline_header(value: Optional[str], default_s: float) -> Deadline:
    """The client's remaining budget from X-RayTPU-Deadline; absent or
    malformed, the route's request timeout."""
    if value:
        try:
            return Deadline.after(float(value))
        except (TypeError, ValueError):
            pass
    return Deadline.after(default_s)


def admission_limit(num_replicas: int, max_ongoing: int, max_queued: int) -> int:
    """A route's in-flight ceiling at the proxy: capacity (replicas x
    max_ongoing) plus the queue allowance (-1 derives 1x capacity)."""
    capacity = max(1, num_replicas) * max(1, max_ongoing)
    return capacity + (capacity if max_queued < 0 else max_queued)


class _Request:
    def __init__(self, method: str, target: str, version: str, headers: dict, body: bytes):
        self.method, self.version, self.headers, self.body = method, version, headers, body
        parts = urlsplit(target)
        self.path = parts.path or "/"
        self.query = dict(parse_qsl(parts.query, keep_blank_values=True))

    def keep_alive(self) -> bool:
        connection = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return connection == "keep-alive"
        return connection != "close"


async def _read_request(reader: asyncio.StreamReader) -> Optional[_Request]:
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise _BadRequest(f"bad request line {line[:80]!r}") from None
    headers = {}
    for _ in range(MAX_HEADERS + 1):
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    else:
        raise _BadRequest("too many request headers")
    if headers.get("transfer-encoding", "").lower() == "chunked":
        body = bytearray()
        while True:
            size = int((await reader.readline()).split(b";")[0], 16)
            if size == 0:
                await reader.readline()
                break
            body += await reader.readexactly(size)
            await reader.readline()
            if len(body) > MAX_BODY_BYTES:
                raise _BadRequest("request body too large")
        body = bytes(body)
    else:
        length = int(headers.get("content-length", "0") or 0)
        if length > MAX_BODY_BYTES:
            raise _BadRequest("request body too large")
        body = await reader.readexactly(length) if length else b""
    return _Request(method, target, version, headers, body)


def _head(status: int, headers: dict) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class HTTPProxy:
    """Serves HTTP on ``host:port`` from this process's serve I/O loop."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host = host
        self.port = port
        self._handles: dict[str, DeploymentHandle] = {}
        self._inflight: dict[str, int] = {}
        self._num_requests = 0
        self._route_hist: dict[str, LatencyHistogram] = {}
        self._route_errors: dict[str, int] = {}
        self._server = run_sync(asyncio.start_server(self._on_client, host, port))

    def ready(self) -> str:
        return "ok"

    # -- connections ----------------------------------------------------
    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    request = await _read_request(reader)
                except (_BadRequest, ValueError) as exc:
                    await self._send(writer, 400, str(exc).encode(), _TEXT, keep_alive=False)
                    break
                if request is None:
                    break
                keep_alive = request.keep_alive()
                await self._respond(request, writer, keep_alive)
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:
            # A failure after a stream's head went out (the generator
            # raised): the connection ends there, as the reference's does.
            traceback.print_exc()
        finally:
            writer.close()

    async def _send(self, writer, status: int, body: bytes, content_type: str,
                    keep_alive: bool, extra: Optional[dict] = None) -> None:
        headers = {"Content-Type": content_type, "Content-Length": str(len(body)),
                   **(extra or {})}
        if not keep_alive:
            headers["Connection"] = "close"
        writer.write(_head(status, headers) + body)
        await writer.drain()

    # -- the stats the controller reads (on the I/O loop) ---------------
    def _observe_route(self, route: str, seconds: float, error: bool,
                       status: str | None = None) -> None:
        hist = self._route_hist.get(route)
        if hist is None:
            hist = self._route_hist[route] = LatencyHistogram()
        hist.observe(seconds)
        if error:
            self._route_errors[route] = self._route_errors.get(route, 0) + 1
        metrics_mod.record_serve_request(route, seconds, status or ("500" if error else "200"))

    # The actor's calls read the loop's state on the loop.
    def get_route_stats(self) -> dict:
        """{route: {count, p50_ms, p95_ms, p99_ms, mean_ms, max_ms, errors,
        inflight}}: ``inflight`` the route's requests this proxy holds now."""
        async def read():
            return {route: {**hist.snapshot(), "errors": self._route_errors.get(route, 0),
                            "inflight": self._inflight.get(route, 0)}
                    for route, hist in self._route_hist.items()}
        return run_sync(read(), timeout=10)

    def get_num_requests(self) -> int:
        return self._num_requests

    def get_reliability_stats(self) -> dict:
        """Hedges, retries and breaker states of this proxy's routers, summed
        over its routes."""
        async def read():
            total: collections.Counter = collections.Counter()
            seen: set = set()
            for handle in self._handles.values():
                stats = handle._get_router().reliability()
                seen.update(stats.pop("breaker_states_seen"))
                stats.pop("breakers")
                total.update(stats)
            return {**total, "breaker_states_seen": sorted(seen)}
        return run_sync(read(), timeout=10)

    # -- requests -------------------------------------------------------
    def _handle_for(self, qualified: str) -> DeploymentHandle:
        handle = self._handles.get(qualified)
        if handle is None:
            app_name, dep_name = qualified.split("_", 1)
            handle = self._handles[qualified] = DeploymentHandle(dep_name, app_name)
        return handle

    def _route_policy(self, qualified: str) -> dict:
        info = get_subscriber().get_replicas(qualified)
        policy = dict(info.get("policy") or {})
        policy.setdefault("max_ongoing_requests", info.get("max_ongoing_requests", 100))
        policy["num_replicas"] = len(info.get("actor_names", ()))
        return policy

    async def _respond(self, request: _Request, writer, keep_alive: bool) -> None:
        send = lambda status, text, ctype=_TEXT, **kw: self._send(  # noqa: E731
            writer, status, text.encode() if isinstance(text, str) else text, ctype,
            keep_alive, **kw)
        path = request.path
        if path == "/-/healthz":
            return await send(200, "ok")
        # Chaos: an armed "serve.proxy.kill" takes this proxy's process down
        # mid-request; the controller restarts it.
        try:
            chaos.failpoint("serve.proxy.kill")
        except chaos.ChaosFault:
            os._exit(1)
        routes = get_subscriber().get_routes()
        if path == "/-/routes":
            return await send(200, json.dumps(routes), _JSON)
        match = match_route(routes, path)
        if match is None:
            return await send(404, f"no route for {path}")
        _, qualified = match
        policy = self._route_policy(qualified)
        deadline = parse_deadline_header(request.headers.get(DEADLINE_HEADER.lower()),
                                         float(policy.get("request_timeout_s", 60.0)))
        limit = admission_limit(policy.get("num_replicas", 1),
                                policy.get("max_ongoing_requests", 100),
                                policy.get("max_queued_requests", -1))
        if self._inflight.get(qualified, 0) >= limit:
            return await self._shed(send, deadline, qualified=qualified, where="proxy")
        if request.method in ("POST", "PUT", "PATCH"):
            try:
                body: Any = json.loads(request.body) if request.body else None
            except ValueError:
                body = request.body
        else:
            body = dict(request.query)
        handle = self._handle_for(qualified)
        session_id = request.headers.get("x-raytpu-session", "")
        if not session_id and isinstance(body, dict):
            session_id = str(body.get("session_id", "") or "")
        if session_id:
            handle = handle.options(session_id=session_id)
        self._num_requests += 1
        # An incoming trace context rides the X-RayTPU-Trace header
        # ("<trace_id>:<span_id>"); without one the proxy starts a trace.
        parent = None
        header = request.headers.get("x-raytpu-trace")
        if header and ":" in header:
            trace_id, _, span_id = header.partition(":")
            parent = {"trace_id": trace_id, "span_id": span_id}
        trace_scope = (tracing.span(f"serve.request {path}", parent=parent,
                                    method=request.method, route=qualified)
                       if tracing.enabled() else contextlib.nullcontext())
        start = time.perf_counter()
        self._inflight[qualified] = self._inflight.get(qualified, 0) + 1
        try:
            try:
                # The handle's call takes this span as its replica span's parent.
                with trace_scope:
                    result = await DeploymentResponse(handle, (body,), {},
                                                      deadline)._result_async()
            except RequestShedError as exc:
                return await self._shed(send, deadline, exc.retry_after_s, qualified=qualified,
                                        where="replica")
            except TimeoutError as exc:  # DeadlineExceededError included
                self._observe_route(qualified, time.perf_counter() - start, error=True,
                                    status="504")
                return await send(504, f"deadline exceeded: {exc}")
            except RuntimeError as exc:
                if "no available replica" in str(exc):
                    return await self._shed(send, deadline, qualified=qualified,
                                            where="router")
                self._observe_route(qualified, time.perf_counter() - start, error=True)
                return await send(500, f"{type(exc).__name__}: {exc}")
            except Exception as exc:
                self._observe_route(qualified, time.perf_counter() - start, error=True)
                return await send(500, f"{type(exc).__name__}: {exc}")
            # A stream's time is to its first dispatch: its length measures
            # the client's reading, not the serving.
            self._observe_route(qualified, time.perf_counter() - start, error=False)
            if isinstance(result, ResponseStream):
                return await self._stream(request, writer, result, keep_alive)
            if isinstance(result, bytes):
                return await send(200, result, "application/octet-stream")
            if isinstance(result, str):
                return await send(200, result)
            try:
                return await send(200, json.dumps(result), _JSON)
            except TypeError:
                return await send(200, str(result))
        finally:
            self._inflight[qualified] = max(0, self._inflight.get(qualified, 1) - 1)

    async def _shed(self, send, deadline: Deadline, retry_after_s: Optional[float] = None, *,
                    qualified: str = "", where: str = "proxy"):
        """A fast 503 with a Retry-After capped by the request's budget."""
        metrics_mod.inc_serve_reliability("shed", route=qualified, where=where)
        metrics_mod.record_serve_request(qualified, 0.0, "503")
        hint = retry_after_s if retry_after_s is not None else 1.0
        if not deadline.is_unbounded():
            hint = min(hint, deadline.remaining())
        return await send(503, "overloaded: request shed by admission control",
                          extra={"Retry-After": f"{max(0.0, hint):.3f}"})

    async def _stream(self, request: _Request, writer, stream: ResponseStream,
                      keep_alive: bool) -> None:
        """A generator's items as SSE (Accept: text/event-stream) or as
        newline-delimited chunks."""
        sse = "text/event-stream" in request.headers.get("accept", "")
        headers = {"Content-Type": "text/event-stream" if sse else "application/octet-stream",
                   "Cache-Control": "no-cache", "Transfer-Encoding": "chunked"}
        if not keep_alive:
            headers["Connection"] = "close"
        writer.write(_head(200, headers))
        try:
            while True:
                batch = await stream._next_batch()
                if not batch:
                    break
                for item in batch:
                    if isinstance(item, bytes):
                        text = item.decode("utf-8", "replace")
                    elif isinstance(item, str):
                        text = item
                    else:
                        try:
                            text = json.dumps(item)
                        except TypeError:
                            text = str(item)
                    data = (f"data: {text}\n\n" if sse else text + "\n").encode()
                    writer.write(b"%x\r\n%s\r\n" % (len(data), data))
                await writer.drain()
        except BaseException:
            # A client gone, an encoding error, a cancel: free the stream.
            await stream._cancel()
            raise
        writer.write(b"0\r\n\r\n")
        await writer.drain()
