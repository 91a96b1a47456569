"""Driver/worker global runtime state and the implementation of the
top-level API (init/shutdown/get/put/wait/kill/...).

Role-equivalent of python/ray/_private/worker.py in the reference
(:: init, connect, get, put, wait, Worker global state, log listeners).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Any, Sequence

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import global_config, reset_config
from ray_tpu_torch._private.core_context import CoreContext
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.node import LocalCluster
from ray_tpu_torch._private.object_ref import ObjectRef

_global_ctx: CoreContext | None = None
_local_cluster: LocalCluster | None = None
_is_driver = False
_lock = threading.RLock()
_runtime_context_extras: dict = {}


def set_global_context(ctx: CoreContext, is_driver: bool) -> None:
    global _global_ctx, _is_driver
    _global_ctx = ctx
    _is_driver = is_driver


def get_global_context() -> CoreContext:
    if _global_ctx is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first"
        )
    return _global_ctx


def is_initialized() -> bool:
    return _global_ctx is not None


def init(
    address: str | None = None,
    *,
    num_cpus: int | None = None,
    num_gpus: float | None = None,
    resources: dict | None = None,
    object_store_memory: int | None = None,
    log_to_driver: bool = True,
    namespace: str = "default",
    runtime_env: dict | None = None,
    autoscaling: "str | dict | None" = None,
    _system_config: dict | None = None,
    ignore_reinit_error: bool = False,
) -> dict:
    """Start (or connect to) a cluster and connect this process as driver.

    Like the reference's ray.init(): no address starts a local head
    (controller + node agent subprocesses + shm store); ``address`` of the
    form "host:port" (controller) connects to an existing cluster.
    Resources are *assertions* (resource lying is supported for tests, see
    SURVEY §4.4.3): pass ``num_gpus=1`` (or ``resources={"GPU": 1}``) on a
    laptop and the scheduler will believe you; without it the node agent
    counts the cards ``nvidia-smi`` lists under ``CUDA_VISIBLE_DEVICES``.
    ``autoscaling=`` waits for the port's autoscaler (ROADMAP item 14d).
    """
    global _local_cluster
    with _lock:
        if _global_ctx is not None:
            if ignore_reinit_error:
                return runtime_info()
            raise RuntimeError("ray_tpu_torch.init() called twice")
        if autoscaling is not None:
            raise NotImplementedError(
                "init(autoscaling=...) needs the port's autoscaler, which is "
                "ROADMAP Queue A item 14d")
        global_config().apply_system_config(_system_config)

        job_id = JobID.random()
        if address == "auto":
            # Reference's ray.init("auto"): resolve from the environment
            # (set for job-submission drivers and `ray_tpu_torch start` shells).
            address = os.environ.get("RAYTPU_ADDRESS")
            if not address:
                raise ConnectionError(
                    'init("auto") needs RAYTPU_ADDRESS in the environment'
                )
        if address is None:
            custom = dict(resources or {})
            if num_cpus is not None:
                custom["CPU"] = num_cpus
            if num_gpus is not None:
                custom["GPU"] = num_gpus
            cluster = LocalCluster()
            cluster.start_head(
                resources=custom,
                store_capacity=object_store_memory or 0,
            )
            _local_cluster = cluster
            # Driver-side tracing/profile exports land in the session dir
            # (workers inherit it via RAYTPU_SESSION_DIR at spawn).
            os.environ["RAYTPU_SESSION_DIR"] = cluster.session_dir
            from ray_tpu_torch.util import tracing as _tracing

            _tracing.configure(cluster.session_dir)
            controller_addr = cluster.controller_addr
            agent_addr = cluster.head_agent_addr
            store_info = cluster.head_store_info
            node_id = cluster.head_node_id
        else:
            host, port = address.rsplit(":", 1)
            controller_addr = (host, int(port))
            agent_addr, store_info, node_id = _discover_local_node(controller_addr)

        ctx = CoreContext(
            job_id=job_id,
            node_id=node_id,
            controller_addr=controller_addr,
            agent_addr=agent_addr,
            store_info=store_info,
            is_driver=True,
        )
        ctx.connect()
        set_global_context(ctx, is_driver=True)
        _runtime_context_extras["namespace"] = namespace
        _runtime_context_extras["runtime_env"] = runtime_env or {}
        if log_to_driver:
            _subscribe_logs(ctx, job_id)
        atexit.register(shutdown)
        return runtime_info()


def _discover_local_node(controller_addr: tuple) -> tuple:
    """Connect-to-existing: pick an agent (prefer one on this host)."""
    from ray_tpu_torch._private.rpc import RpcClient

    probe = CoreContextProbe(controller_addr)
    nodes = probe.call("list_nodes", {})
    probe.close()
    alive = [n for n in nodes if n["alive"]]
    if not alive:
        raise RuntimeError("no alive nodes in cluster")
    node = alive[0]
    return tuple(node["agent_addr"]), node["store_info"], node["node_id"]


class CoreContextProbe:
    """Minimal one-shot RPC helper usable before the main context exists."""

    def __init__(self, addr: tuple):
        from ray_tpu_torch._private.rpc import IoThread, RpcClient

        self.io = IoThread("probe-io")
        self.client = RpcClient(tuple(addr), name="probe")
        self.io.run(self.client.connect())

    def call(self, method: str, payload: Any, timeout: float | None = 30) -> Any:
        return self.io.run(self.client.call(method, payload), timeout)

    def close(self) -> None:
        try:
            self.io.run(self.client.close())
        except Exception:  # rtlint: disable=swallowed-exception - close of a dead controller conn at shutdown
            pass
        self.io.stop()


def _subscribe_logs(ctx: CoreContext, job_id: str) -> None:
    """Print worker stdout/stderr with (pid=) prefixes, like the reference's
    log monitor → driver pipeline."""

    def on_log(message):
        if message.get("job_id") not in ("", job_id):
            return
        stream = sys.stderr if message.get("kind") == "err" else sys.stdout
        print(f"(pid={message.get('pid')}) {message.get('line')}", file=stream)

    ctx.controller.on_push("logs", on_log)
    ctx.io.run(ctx.subscribe_channels(["logs", "error"]))


def shutdown() -> None:
    global _global_ctx, _local_cluster
    with _lock:
        if _global_ctx is not None:
            # The reference closes its compiled graphs here; the port's run
            # on ``_private/local_tasks.py``'s actors, not on this runtime,
            # until ROADMAP item 14b-ii-b moves them.
            _global_ctx.shutdown()
            _global_ctx = None
        if _local_cluster is not None:
            _local_cluster.shutdown()
            _local_cluster = None


def runtime_info() -> dict:
    ctx = get_global_context()
    return {
        "job_id": ctx.job_id,
        "node_id": ctx.node_id,
        "controller_address": f"{ctx.controller_addr[0]}:{ctx.controller_addr[1]}",
        "session_dir": (
            _local_cluster.session_dir if _local_cluster is not None else None
        ),
    }


# ---------------------------------------------------------------------------
# public API implementations
# ---------------------------------------------------------------------------
def put(value: Any) -> ObjectRef:
    return get_global_context().put(value)


def _check_refs(refs) -> None:
    """A ``_private/local_tasks.py`` ref is another type than this runtime's
    until that layer moves onto the runtime (ROADMAP item 14b-ii-b): refuse it
    at once rather than wait on an id the runtime never made."""
    for ref in refs if isinstance(refs, (list, tuple)) else [refs]:
        if type(ref).__module__ == "ray_tpu_torch._private.local_tasks":
            raise TypeError(
                "ray_tpu_torch.get/wait take the runtime's ObjectRefs, not "
                "local_tasks.ObjectRef: the local task layer moves onto the "
                "runtime in ROADMAP Queue A item 14b-ii-b")


def get(refs, timeout: float | None = None):
    _check_refs(refs)
    return get_global_context().get(refs, timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
    fetch_local: bool = True,
):
    refs = list(refs)
    _check_refs(refs)
    return get_global_context().wait(
        refs, num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def kill(actor, *, no_restart: bool = True) -> None:
    ctx = get_global_context()
    ctx.io.run(
        ctx.controller.call(
            "kill_actor",
            {"actor_id": actor._actor_id, "no_restart": no_restart},
        )
    )


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel the task that creates ``ref`` (reference: ray.cancel /
    test_cancel.py semantics). Queued tasks fail with TaskCancelledError;
    running tasks get KeyboardInterrupt (force=False) or their worker
    SIGKILLed (force=True -> WorkerCrashedError); finished tasks no-op."""
    get_global_context().cancel(ref, force=force)


def nodes() -> list[dict]:
    ctx = get_global_context()
    return ctx.io.run(ctx.controller.call("list_nodes", {}))


def cluster_resources() -> dict:
    ctx = get_global_context()
    return ctx.io.run(ctx.controller.call("cluster_resources", {}))


def available_resources() -> dict:
    ctx = get_global_context()
    return ctx.io.run(ctx.controller.call("available_resources", {}))


def timeline(filename: str | None = None) -> dict:
    """Chrome-trace JSON for the whole session, spans merged with the
    controller's task events and counter snapshots. The controller half of
    ``util/timeline.py`` is ROADMAP item 14b-ii-b; the span half is
    ``util.timeline.build_chrome_trace`` on a session directory."""
    raise NotImplementedError(
        "timeline() merges the controller's task events into the trace, the "
        "controller half of util/timeline.py: ROADMAP Queue A item 14b-ii-b")
