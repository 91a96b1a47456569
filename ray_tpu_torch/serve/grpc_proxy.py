"""The gRPC proxy: the serve plane's second ingress protocol.

The port's copy of ray_tpu's ``serve/_private/grpc_proxy.py``: a detached
actor (``SERVE_GRPC_PROXY::<port>``) running a ``grpc.aio`` server on a
thread and event loop of its own, exposing the applications through two
generic methods, with no compiled user protos (a JSON envelope keeps the
ingress schema-free):

  /raytpu.serve.Serve/Predict        (unary)   route and payload -> result
  /raytpu.serve.Serve/PredictStream  (server streaming) one message for
                                     each item of a streaming deployment

A request is the JSON bytes ``{"route": "/app", "data": <payload>}``; a
reply is the result as JSON (bytes results pass as they are). Route
matching and the membership are the HTTP proxy's. ``grpc`` is imported
when the proxy starts, never with ``ray_tpu_torch.serve``: a machine
without grpcio serves HTTP all the same.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any

from ray_tpu_torch.serve._common import (
    DEADLINE_METADATA_KEY, Deadline, DeadlineExceededError, RequestShedError,
    reset_current_deadline, set_current_deadline,
)
from ray_tpu_torch.serve.handle import DeploymentHandle, ResponseStream
from ray_tpu_torch.serve.long_poll import get_subscriber
from ray_tpu_torch.serve.routing import match_route

SERVICE = "raytpu.serve.Serve"


class GRPCProxy:
    """Serves gRPC on ``host:port`` from a thread of its own."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        self.host = host
        self.port = port
        self._handles: dict[str, DeploymentHandle] = {}
        self._num_requests = 0
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server = None
        self._started = threading.Event()
        self._start_error: Exception | None = None
        self._thread = threading.Thread(target=self._serve_forever, name="serve-grpc",
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError(f"gRPC proxy failed to start: {self._start_error}")
        if self._start_error is not None:
            raise self._start_error

    def _serve_forever(self) -> None:
        try:
            asyncio.run(self._amain())
        except Exception as exc:
            self._start_error = exc
            self._started.set()

    async def _amain(self) -> None:
        import grpc

        self._loop = asyncio.get_running_loop()
        server = grpc.aio.server()

        def unary(method):
            return grpc.unary_unary_rpc_method_handler(
                method, request_deserializer=lambda b: b, response_serializer=lambda b: b)

        def streaming(method):
            return grpc.unary_stream_rpc_method_handler(
                method, request_deserializer=lambda b: b, response_serializer=lambda b: b)

        handler = grpc.method_handlers_generic_handler(SERVICE, {
            "Predict": unary(self._predict),
            "PredictStream": streaming(self._predict_stream),
            "Healthz": unary(self._healthz),
        })
        server.add_generic_rpc_handlers((handler,))
        bound = server.add_insecure_port(f"{self.host}:{self.port}")
        if bound == 0:
            raise RuntimeError(f"gRPC proxy could not bind {self.port}")
        self.port = bound
        await server.start()
        self._server = server
        self._started.set()
        await server.wait_for_termination()

    def ready(self) -> str:
        return "ok"

    def shutdown(self) -> None:
        if self._loop is not None and self._server is not None:
            asyncio.run_coroutine_threadsafe(self._server.stop(None), self._loop).result(10)
        self._thread.join(10)

    def _handle_for(self, qualified: str) -> DeploymentHandle:
        handle = self._handles.get(qualified)
        if handle is None:
            app_name, dep_name = qualified.split("_", 1)
            handle = self._handles[qualified] = DeploymentHandle(dep_name, app_name)
        return handle

    def _resolve(self, raw_request: bytes) -> tuple[Any, Any, str]:
        """(handle, data, qualified route). Raises ValueError for a bad
        request and LookupError for an unknown route."""
        try:
            request = json.loads(raw_request or b"{}")
        except json.JSONDecodeError as exc:
            raise ValueError(f"request must be JSON: {exc}") from None
        if not isinstance(request, dict):
            raise ValueError(f"request must be a JSON object, got {type(request).__name__}")
        route = request.get("route", "/")
        match = match_route(get_subscriber().get_routes(), route)
        if match is None:
            raise LookupError(f"no Serve route for {route!r}")
        _, qualified = match
        return self._handle_for(qualified), request.get("data"), qualified

    def _ingress_deadline(self, context, qualified: str) -> Deadline:
        """The tighter of the client's gRPC deadline and the
        ``x-raytpu-deadline`` metadata budget; with neither, the
        deployment's request timeout."""
        budgets = []
        remaining = context.time_remaining()
        if remaining is not None:
            budgets.append(float(remaining))
        try:
            for key, value in context.invocation_metadata() or ():
                if key.lower() == DEADLINE_METADATA_KEY:
                    budgets.append(float(value))
        except (TypeError, ValueError):
            pass  # a malformed budget: the others, or the deployment's
        if not budgets:
            policy = get_subscriber().get_replicas(qualified).get("policy") or {}
            budgets.append(float(policy.get("request_timeout_s", 60.0)))
        return Deadline.after(min(budgets))

    @staticmethod
    def _call_with_deadline(handle, data, deadline: Deadline):
        """A worker thread's call: the deadline is the ambient one, and every
        timeout below derives from it."""
        token = set_current_deadline(deadline)
        try:
            return handle.remote(data).result()
        finally:
            reset_current_deadline(token)

    @staticmethod
    def _encode(item: Any) -> bytes:
        if isinstance(item, bytes):
            return item
        try:
            return json.dumps(item).encode()
        except TypeError:
            return str(item).encode()

    async def _call(self, request: bytes, context):
        """The deployment's result, or the call aborted with its status."""
        import grpc

        self._num_requests += 1
        try:
            handle, data, qualified = self._resolve(request)
            deadline = self._ingress_deadline(context, qualified)
            return await asyncio.to_thread(self._call_with_deadline, handle, data, deadline)
        except LookupError as exc:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(exc))
        except ValueError as exc:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        except RequestShedError as exc:
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))
        except (DeadlineExceededError, TimeoutError) as exc:
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(exc))
        except Exception as exc:
            await context.abort(grpc.StatusCode.INTERNAL, f"{type(exc).__name__}: {exc}")

    async def _drain(self, stream: ResponseStream, context):
        """A stream's items, batch by batch; the stream is cancelled and the
        call aborted if it fails."""
        import grpc

        try:
            while True:
                batch = await asyncio.to_thread(stream.next_batch)
                if not batch:
                    return
                for item in batch:
                    yield item
        except BaseException as exc:
            await asyncio.to_thread(stream.cancel)
            await context.abort(grpc.StatusCode.INTERNAL,
                                f"stream failed: {type(exc).__name__}: {exc}")

    # -- the methods ------------------------------------------------------
    async def _healthz(self, request: bytes, context) -> bytes:
        return b"ok"

    async def _predict(self, request: bytes, context) -> bytes:
        result = await self._call(request, context)
        if isinstance(result, ResponseStream):
            # A unary caller of a streaming deployment gets every item at once.
            return self._encode([item async for item in self._drain(result, context)])
        return self._encode(result)

    async def _predict_stream(self, request: bytes, context):
        result = await self._call(request, context)
        if not isinstance(result, ResponseStream):
            yield self._encode(result)
            return
        async for item in self._drain(result, context):
            yield self._encode(item)

    def get_num_requests(self) -> int:
        return self._num_requests
