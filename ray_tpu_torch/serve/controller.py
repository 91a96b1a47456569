"""ServeController: the reconciler of applications, deployments and replicas.

Port of ray_tpu's ``serve/_private/controller.py``. The reference hosts it
in a detached actor; here it lives in the driver, as the trainer's round
loop does, with its reconcile loop on a thread of its own. It holds the
target state (applications, their deployments and routes) and every
0.25 s starts and stops replica processes to match each deployment's
target, replaces replicas whose process died or whose health check failed,
rolls replicas of an older version, drains replicas before it stops them,
and autoscales from the replicas' ongoing and queued counts and the
proxies' route p99. A second thread, every second, health-checks the
proxies registered with it, restarts a dead one under its name and port,
and scrapes their per-route latencies. Membership
(routes, running replicas and their addresses, each deployment's policy)
is a snapshot routers in the driver read directly and replica processes
receive through ``poll_update`` on the serve wire.

``ray_actor_options={"num_gpus": g}`` places a replica on the host's cards
by fractional share, leased from this process's resource ledger
(``_private.resources``): two replicas at 0.5 share one card. ``num_tpus``
and ``resources`` lease their keys from it too.
The replica's ``CUDA_VISIBLE_DEVICES`` names its card (or none at
``num_gpus`` 0) before the process starts. A replica that does not fit
waits as PENDING in ``get_status``, as the reference's infeasible actor
waits.

Waiting for the runtime core (ROADMAP Queue A item 14): the checkpoint and
restore of the controller's state in the controller's KV store (it lives
and dies with the driver) and drains on the node agent's out-of-memory
telemetry; their methods raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import pickle
import sys
import threading
import time
import traceback
import uuid
from typing import Any, Optional

from ray_tpu_torch._private import resources
from ray_tpu_torch.serve import _channel
from ray_tpu_torch.serve._common import (
    RUNTIME_CORE_ITEM, DeploymentInfo, ReplicaInfo, new_replica_id,
)
from ray_tpu_torch.serve.autoscaling_policy import AutoscalingState
from ray_tpu_torch.serve.replica import CallableRef, replica_main

RECONCILE_PERIOD_S = 0.25
# Proxy liveness and the route-p99 scrape run on a slower tick.
PROXY_CHECK_PERIOD_S = 1.0
# A proxy process's start: an interpreter, torch's import, a bound port.
PROXY_READY_TIMEOUT_S = 120.0
# A replica's constructor may build kernels and warm every batch bucket.
READY_TIMEOUT_S = 900.0
# Replicas of a deployment that fail to start this many times in a row
# stop being replaced, and its application reports DEPLOY_FAILED.
MAX_START_FAILURES = 3


def replica_bundle(options: dict) -> dict:
    """What a replica leases from the ledger: its card share, its TPUs and
    its custom resources (``num_cpus`` reserves nothing on one host)."""
    bundle = {key: float(amount) for key, amount in (options.get("resources") or {}).items()}
    for option, key in (("num_gpus", "GPU"), ("num_tpus", "TPU")):
        if options.get(option):
            bundle[key] = bundle.get(key, 0.0) + float(options[option])
    return bundle


class _Proxy:
    """A proxy registered with the controller: one in this process
    (``local``), or a process the controller started and restarts."""

    def __init__(self, name: str, protocol: str, host: str, port: int, local=None):
        self.name, self.protocol, self.host, self.port = name, protocol, host, int(port)
        self.local = local
        self.process = None
        self.conn = None
        self.address: Optional[tuple] = None
        self.restarts = 0

    def describe(self) -> dict:
        return {"name": self.name, "protocol": self.protocol, "host": self.host,
                "port": self.port, "restarts": self.restarts,
                "pid": self.process.pid if self.process is not None else None}


class _Replica:
    """The controller's record of one replica and its process."""

    def __init__(self, info: ReplicaInfo, need: dict):
        self.info = info
        self.need = need
        self.lease: Optional[resources.Lease] = None
        self.process = None
        self.conn = None
        self.address: Optional[tuple] = None
        self.pid: Optional[int] = None

    @property
    def state(self) -> str:
        return self.info.state

    @state.setter
    def state(self, value: str) -> None:
        self.info.state = value


class ServeController:
    """Target state, the reconcile loop and the membership it publishes."""

    def __init__(self):
        self._lock = threading.RLock()
        self._deployments: dict[str, DeploymentInfo] = {}
        self._replicas: dict[str, list[_Replica]] = {}
        self._autoscalers: dict[str, AutoscalingState] = {}
        self._autoscale_counts: dict[str, int] = {}
        self._routes: dict[str, str] = {}
        self._app_deployments: dict[str, list[str]] = {}
        self._app_status: dict[str, str] = {}
        self._applied_user_config: dict[str, Any] = {}
        self._start_failures: dict[str, list[str]] = {}
        self._last_health_check: dict[str, float] = {}
        self._proxies: dict[str, _Proxy] = {}
        self._route_p99: dict[str, float] = {}
        self._version = 0
        self._instance = uuid.uuid4().hex
        self._snapshot: Optional[dict] = None
        self._pollers: set = set()
        self._stopped = threading.Event()
        self._server = _channel.run_sync(asyncio.start_server(
            lambda r, w: _channel.serve_connection(r, w, self._dispatch), "127.0.0.1", 0))
        self.address = self._server.sockets[0].getsockname()[:2]
        self._thread = threading.Thread(target=self._reconcile_loop, name="serve-controller",
                                        daemon=True)
        self._thread.start()
        self._proxy_thread = threading.Thread(target=self._proxy_loop, name="serve-proxies",
                                              daemon=True)
        self._proxy_thread.start()

    # ------------------------------------------------------------------
    # target state (serve.run, serve.delete, serve.shutdown)
    # ------------------------------------------------------------------
    def deploy_application(self, app_name: str, deployments: list[dict],
                           route_prefix: Optional[str]) -> str:
        with self._lock:
            new_names = []
            for spec in deployments:
                info = DeploymentInfo(
                    name=spec["name"], app_name=app_name, config=spec["config"],
                    cls_or_fn=spec["cls_or_fn"], init_args=spec.get("init_args", ()),
                    init_kwargs=spec.get("init_kwargs", {}),
                    version=spec.get("version") or self._version_of(spec),
                    route_prefix=spec.get("route_prefix"))
                qname = info.qualified_name()
                new_names.append(qname)
                self._deployments[qname] = info
                self._replicas.setdefault(qname, [])
                self._start_failures.pop(qname, None)
                if info.config.autoscaling_config:
                    self._autoscalers[qname] = AutoscalingState(info.config.autoscaling_config)
                    self._autoscale_counts.setdefault(
                        qname, info.config.autoscaling_config.min_replicas)
                # A new user_config reconfigures live replicas in place.
                prev = self._applied_user_config.get(qname, object())
                if prev != info.config.user_config:
                    self._applied_user_config[qname] = info.config.user_config
                    for rep in self._replicas.get(qname, []):
                        if rep.state == "RUNNING" and rep.info.version == info.version:
                            self._call_async(rep, "reconfigure", info.config.user_config)
            for qname in self._app_deployments.get(app_name, []):
                if qname not in new_names:
                    self._deployments.pop(qname, None)
                    self._last_health_check.pop(qname, None)
            self._app_deployments[app_name] = new_names
            self._app_status[app_name] = "DEPLOYING"
            if route_prefix is not None and deployments:
                self._routes[route_prefix] = f"{app_name}_{deployments[-1]['name']}"
            self._bump_version_locked()
        return "ok"

    def delete_application(self, app_name: str) -> str:
        with self._lock:
            for qname in self._app_deployments.pop(app_name, []):
                self._deployments.pop(qname, None)
                self._last_health_check.pop(qname, None)
            self._routes = {r: d for r, d in self._routes.items()
                            if not d.startswith(app_name + "_")}
            self._app_status.pop(app_name, None)
            self._bump_version_locked()
        return "ok"

    def shutdown(self, timeout_s: float = 30.0) -> str:
        """Stops every replica (draining each up to its graceful timeout,
        capped by ``timeout_s``) and the reconcile loop."""
        with self._lock:
            self._deployments.clear()
            self._routes.clear()
            self._app_deployments.clear()
            self._app_status.clear()
            self._bump_version_locked()
        self._stopped.set()
        self._thread.join(timeout=10)
        self._proxy_thread.join(timeout=10)
        with self._lock:
            replicas = [r for reps in self._replicas.values() for r in reps]
            self._replicas.clear()
        stoppers = [self._stop_replica(r, timeout_s=min(timeout_s, 5.0), wait=False)
                    for r in replicas]
        for stopper in stoppers:
            if stopper is not None:
                stopper.join(timeout_s)
        with self._lock:
            proxies, self._proxies = list(self._proxies.values()), {}
        for proxy in proxies:
            self._end_proxy(proxy)
        self._notify_pollers()
        _channel.run_sync(self._close_server(), timeout=10)
        return "ok"

    async def _close_server(self) -> None:
        self._server.close()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def get_routes(self) -> dict:
        with self._lock:
            return dict(self._routes)

    def membership(self) -> dict:
        """Routes, and each deployment's running replicas, their addresses
        and its policy. Recomputed only when the version moves."""
        with self._lock:
            if self._snapshot is None:
                replicas = {}
                for qname, info in self._deployments.items():
                    running = sorted((r for r in self._replicas.get(qname, [])
                                      if r.state == "RUNNING"), key=lambda r: r.info.replica_id)
                    replicas[qname] = {
                        "actor_names": [r.info.replica_id for r in running],
                        "addresses": {r.info.replica_id: r.address for r in running},
                        "max_ongoing_requests": info.config.max_ongoing_requests,
                        "policy": info.config.policy_snapshot(),
                    }
                self._snapshot = {"routes": dict(self._routes), "replicas": replicas}
            return self._snapshot

    def get_status(self) -> dict:
        with self._lock:
            apps = {}
            for app, qnames in self._app_deployments.items():
                deployments, failed = {}, []
                for qname in qnames:
                    reps = self._replicas.get(qname, [])
                    info = self._deployments.get(qname)
                    failures = self._start_failures.get(qname, [])
                    deployments[qname.split("_", 1)[1]] = {
                        "target_replicas": self._target_count(qname, info) if info else 0,
                        "running_replicas": sum(1 for r in reps if r.state == "RUNNING"),
                        "states": [r.state for r in reps],
                    }
                    if len(failures) >= MAX_START_FAILURES:
                        failed.append(f"{qname}: {failures[-1]}")
                all_ok = all(d["running_replicas"] >= d["target_replicas"]
                             for d in deployments.values())
                status = "RUNNING" if all_ok else self._app_status.get(app, "DEPLOYING")
                apps[app] = {"status": "DEPLOY_FAILED" if failed else status,
                             "deployments": deployments}
                if failed:
                    apps[app]["message"] = "\n".join(failed)
            return apps

    def get_route_p99(self) -> dict:
        """The worst p99 (ms) over the proxies of each route's deployment, as
        the last scrape read it."""
        with self._lock:
            return dict(self._route_p99)

    # ------------------------------------------------------------------
    # the proxies
    # ------------------------------------------------------------------
    def register_proxy(self, name: str, protocol: str, host: str, port: int,
                       local=None) -> str:
        """Takes a proxy into the controller's care. Without ``local`` the
        controller starts it as a process of its own and restarts it under
        the same name and port when it dies."""
        proxy = _Proxy(name, protocol, host, port, local)
        if local is None:
            self._start_proxy(proxy)
        with self._lock:
            old = self._proxies.get(name)
            self._proxies[name] = proxy
        if old is not None:
            self._end_proxy(old)
        return "ok"

    def unregister_proxy(self, name: str) -> str:
        with self._lock:
            proxy = self._proxies.pop(name, None)
        if proxy is not None:
            self._end_proxy(proxy)
        return "ok"

    def get_proxies(self) -> list:
        with self._lock:
            return [p.describe() for p in self._proxies.values()]

    def proxy_call(self, name: str, method: str, timeout: float = 10.0) -> Any:
        """A registered proxy's ``method`` (``get_route_stats``,
        ``get_num_requests``, ``get_reliability_stats``), or None if it did
        not answer."""
        with self._lock:
            proxy = self._proxies.get(name)
        if proxy is None:
            return None
        try:
            if proxy.local is not None:
                return _channel.run_sync(getattr(proxy.local, method)(), timeout)
            if proxy.address is None:
                return None
            return _channel.run_sync(_channel_call(proxy.address, method), timeout)
        except (ConnectionError, TimeoutError, _channel.RemoteError):
            return None

    def _start_proxy(self, proxy: _Proxy) -> None:
        """Starts the proxy's process and waits until it serves; raises if
        it does not."""
        import torch.multiprocessing as mp

        from ray_tpu_torch.serve.proxy import proxy_main

        ctx = mp.get_context("spawn")
        parent, child = ctx.Pipe()
        spec = {"name": proxy.name, "protocol": proxy.protocol, "host": proxy.host,
                "port": proxy.port, "controller": self.address,
                "env": {"CUDA_VISIBLE_DEVICES": ""}}
        process = ctx.Process(target=proxy_main, args=(spec, child),
                              name=f"serve-proxy-{proxy.port}")
        with resources.child_visible_devices(""):
            process.start()
        child.close()
        message = None
        try:
            if parent.poll(PROXY_READY_TIMEOUT_S):
                message = parent.recv()
        except (EOFError, OSError):
            pass
        if not message or message[0] != "ready":
            process.kill()
            process.join(5.0)
            parent.close()
            reason = message[1] if message else f"exit code {process.exitcode}"
            raise RuntimeError(f"proxy {proxy.name} did not start: {reason}")
        proxy.process, proxy.conn = process, parent
        proxy.address = tuple(message[1]["address"])

    def _end_proxy(self, proxy: _Proxy) -> None:
        if proxy.local is not None or proxy.process is None:
            return
        with contextlib.suppress(OSError, BrokenPipeError):
            proxy.conn.send(("stop",))
        proxy.process.join(5.0)
        if proxy.process.is_alive():
            proxy.process.kill()
            proxy.process.join(5.0)
        proxy.conn.close()

    def _ensure_proxies(self) -> None:
        """Health-checks each proxy process; restarts a dead one under the
        same name and port, so that clients holding its address recover."""
        with self._lock:
            proxies = [p for p in self._proxies.values() if p.local is None]
        for proxy in proxies:
            if (proxy.process is not None and proxy.process.exitcode is None
                    and self.proxy_call(proxy.name, "get_num_requests", timeout=5.0) is not None):
                continue
            print(f"serve: proxy {proxy.name} is down; restarting it", file=sys.stderr,
                  flush=True)
            self._end_proxy(proxy)
            proxy.process = proxy.address = None
            try:
                self._start_proxy(proxy)
            except (RuntimeError, OSError):
                # The port may not be free yet; the next tick tries again.
                traceback.print_exc()
                continue
            proxy.restarts += 1
            with self._lock:
                gone = self._proxies.get(proxy.name) is not proxy
            if gone:  # unregistered, or serve shut down, meanwhile
                self._end_proxy(proxy)

    def _scrape_route_p99(self) -> None:
        """Each HTTP proxy's per-route p99 for the autoscaler; a route that
        several proxies serve reports its worst."""
        with self._lock:
            names = [p.name for p in self._proxies.values() if p.protocol == "http"]
        merged: dict[str, float] = {}
        for name in names:
            for route, snap in (self.proxy_call(name, "get_route_stats", timeout=5.0)
                                or {}).items():
                merged[route] = max(merged.get(route, 0.0), snap["p99_ms"])
        with self._lock:
            self._route_p99.update(merged)

    # ------------------------------------------------------------------
    # waiting for the runtime core
    # ------------------------------------------------------------------
    def _save_checkpoint(self) -> None:
        raise NotImplementedError(f"the controller's checkpoint in the controller's KV store "
                                  f"waits for the runtime core ({RUNTIME_CORE_ITEM})")

    def _restore_checkpoint(self) -> None:
        raise NotImplementedError(f"the controller's restore from the controller's KV store "
                                  f"waits for the runtime core ({RUNTIME_CORE_ITEM})")

    def _drain_oom_flagged(self) -> None:
        raise NotImplementedError(f"drains on the node agent's oom_risk telemetry wait for the "
                                  f"runtime core ({RUNTIME_CORE_ITEM})")

    def get_metrics(self) -> dict:
        """Each deployment's running replicas' metrics."""
        with self._lock:
            running = {q: [r for r in reps if r.state == "RUNNING"]
                       for q, reps in self._replicas.items()}
        out = {}
        for qname, reps in running.items():
            out[qname] = [m for m in (self._call(r, "get_metrics", timeout=10) for r in reps)
                          if m is not None]
        return out

    # ------------------------------------------------------------------
    # the membership channel (long poll)
    # ------------------------------------------------------------------
    async def _dispatch(self, method: str, args: tuple, kwargs: dict) -> Any:
        if method != "poll_update":
            raise AttributeError(f"the controller has no call {method!r}")
        return await self.poll_update(*args, **kwargs)

    def _bump_version_locked(self) -> None:
        self._version += 1
        self._snapshot = None
        self._notify_pollers()

    def _notify_pollers(self) -> None:
        for loop, event in list(self._pollers):
            loop.call_soon_threadsafe(event.set)

    async def poll_update(self, last_version: int = -1, timeout_s: float = 10.0) -> dict:
        """Answers when the membership version passes ``last_version`` (or
        after ``timeout_s``) with the snapshot."""
        entry = (asyncio.get_running_loop(), asyncio.Event())
        with self._lock:
            ready = self._version > last_version or self._stopped.is_set()
            if not ready:
                self._pollers.add(entry)
        if not ready:
            try:
                await asyncio.wait_for(entry[1].wait(), timeout_s)
            except asyncio.TimeoutError:
                pass
            finally:
                with self._lock:
                    self._pollers.discard(entry)
        with self._lock:
            return {"version": self._version, "instance": self._instance, **self.membership()}

    # ------------------------------------------------------------------
    # calls to replicas, from the reconcile thread
    # ------------------------------------------------------------------
    def _call(self, rep: _Replica, method: str, *args, timeout: float = 5.0) -> Any:
        """The replica's ``method``, or None if it failed or timed out."""
        if rep.address is None:
            return None
        try:
            return _channel.run_sync(_channel_call(rep.address, method, *args), timeout)
        except (ConnectionError, TimeoutError, _channel.RemoteError):
            return None

    def _call_async(self, rep: _Replica, method: str, *args) -> None:
        """Sends a call without waiting; a failure is the health check's."""
        future = _channel.submit(_channel_call(rep.address, method, *args))
        future.add_done_callback(_log_failure)

    # ------------------------------------------------------------------
    # the reconcile loop
    # ------------------------------------------------------------------
    def _reconcile_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                self._reconcile_once()
            except Exception:
                traceback.print_exc()
            self._stopped.wait(RECONCILE_PERIOD_S)

    def _target_count(self, qname: str, info: DeploymentInfo) -> int:
        if info.config.autoscaling_config:
            return self._autoscale_counts.get(qname, info.config.autoscaling_config.min_replicas)
        return info.config.num_replicas

    def _proxy_loop(self) -> None:
        while not self._stopped.wait(PROXY_CHECK_PERIOD_S):
            try:
                self._ensure_proxies()
                self._scrape_route_p99()
            except Exception:
                traceback.print_exc()

    def _reconcile_once(self) -> None:
        with self._lock:
            targets = dict(self._deployments)
            gone = [self._replicas.pop(q) for q in list(self._replicas) if q not in targets]
        for rep in (r for reps in gone for r in reps):
            self._stop_replica(rep, timeout_s=5.0)
        for qname, info in targets.items():
            self._autoscale(qname, info)
            self._reconcile_deployment(qname, info)
            self._health_check(qname, info)

    def _reconcile_deployment(self, qname: str, info: DeploymentInfo) -> None:
        """One deployment's pass: roll old versions, reap dead replicas,
        place pending ones, and start or stop replicas to the target."""
        target = self._target_count(qname, info)
        with self._lock:
            replicas = self._replicas.setdefault(qname, [])
            stale = [r for r in replicas if r.info.version != info.version]
            dead = [r for r in replicas if r.state == "DEAD"
                    or (r.state in ("STARTING", "RUNNING") and r.process is not None
                        and r.process.exitcode is not None)]
            for rep in stale + [r for r in dead if r not in stale]:
                replicas.remove(rep)
        for rep in stale:
            self._stop_replica(rep, timeout_s=info.config.graceful_shutdown_timeout_s)
        for rep in dead:
            # A kill or a crash; the pass starts the replacement.
            self._stop_replica(rep, timeout_s=0.0)
        for rep in [r for r in replicas if r.state == "PENDING"]:
            self._place(rep, info)
        with self._lock:
            alive = [r for r in replicas if r.state in ("PENDING", "STARTING", "RUNNING")]
            missing = 0
            if len(self._start_failures.get(qname, [])) < MAX_START_FAILURES:
                missing = max(0, target - len(alive))
            # Scale down the newest first, pending before placed ones.
            order = sorted(alive, key=lambda r: (r.state != "PENDING", -r.info.started_at))
            excess = order[: max(0, len(alive) - target)]
            for rep in excess:
                replicas.remove(rep)
        for rep in excess:
            self._stop_replica(rep, timeout_s=info.config.graceful_shutdown_timeout_s)
        for _ in range(missing):
            replica_id = new_replica_id(qname)
            rep = _Replica(ReplicaInfo(replica_id=replica_id, deployment=qname,
                                       actor_name=replica_id, state="PENDING",
                                       version=info.version),
                           replica_bundle(info.config.ray_actor_options))
            with self._lock:
                replicas.append(rep)
            self._place(rep, info)

    def _place(self, rep: _Replica, info: DeploymentInfo) -> bool:
        try:
            rep.lease = resources.ledger().acquire(rep.need)
        except resources.PlacementGroupUnschedulableError:
            # Stays PENDING until what it needs frees, or is declared.
            return False
        self._launch(rep, info)
        return True

    def _launch(self, rep: _Replica, info: DeploymentInfo) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        parent, child = ctx.Pipe()
        visible = rep.lease.visible_devices()
        spec = {
            "replica_id": rep.info.replica_id, "deployment": info.qualified_name(),
            "callable": CallableRef(info.cls_or_fn), "init_args": info.init_args,
            "init_kwargs": info.init_kwargs, "user_config": info.config.user_config,
            "version": info.version, "limits": info.config.policy_snapshot(),
            "controller": self.address, "env": {"CUDA_VISIBLE_DEVICES": visible},
        }
        process = ctx.Process(target=replica_main, args=(spec, child),
                              name=f"serve-replica-{rep.info.replica_id}")
        try:
            with resources.child_visible_devices(visible):
                process.start()
        except Exception:  # the spec did not pickle, or no process
            with self._lock:
                self._start_failures.setdefault(rep.info.deployment, []).append(
                    traceback.format_exc())
                rep.lease.release()
                rep.lease = None
                rep.state = "DEAD"
            child.close()
            parent.close()
            return
        child.close()
        rep.process, rep.conn, rep.pid = process, parent, process.pid
        rep.info.started_at = time.time()
        rep.state = "STARTING"
        threading.Thread(target=self._await_ready, args=(rep,), daemon=True).start()

    def _await_ready(self, rep: _Replica) -> None:
        """STARTING -> RUNNING when the replica reports its address; DEAD
        if its constructor raised or the process ended first."""
        message = None
        try:
            if rep.conn.poll(READY_TIMEOUT_S):
                message = rep.conn.recv()
        except (EOFError, OSError):
            pass
        qname = rep.info.deployment
        with self._lock:
            if rep.state != "STARTING":
                return  # stopped while it started
            if message and message[0] == "ready":
                rep.address = tuple(message[1]["address"])
                rep.state = "RUNNING"
                self._start_failures.pop(qname, None)
            else:
                reason = (message[1] if message else
                          f"replica process ended before it was ready (exit code "
                          f"{rep.process.exitcode})")
                print(f"serve: replica {rep.info.replica_id} failed to start:\n{reason}",
                      file=sys.stderr, flush=True)
                self._start_failures.setdefault(qname, []).append(reason)
                rep.state = "DEAD"
            self._bump_version_locked()

    def _stop_replica(self, rep: _Replica, timeout_s: float = 20.0,
                      wait: bool = False) -> Optional[threading.Thread]:
        """Drain, then stop: the replica leaves the membership at once,
        finishes what it holds up to ``timeout_s``, and its process ends."""
        with self._lock:
            was = rep.state
            rep.state = "DRAINING"
            if was == "RUNNING":
                self._bump_version_locked()  # out of the membership now
            if was == "PENDING":
                rep.state = "DEAD"
                return None

        def stop():
            if was == "RUNNING":
                self._call(rep, "drain")
                deadline = time.monotonic() + timeout_s
                while time.monotonic() < deadline:
                    ongoing = self._call(rep, "get_num_ongoing")
                    if not ongoing:
                        break
                    time.sleep(0.1)
            self._end_process(rep)

        thread = threading.Thread(target=stop, daemon=True)
        thread.start()
        if wait:
            thread.join()
        return thread

    def _end_process(self, rep: _Replica) -> None:
        if rep.process is not None:
            with contextlib.suppress(OSError, BrokenPipeError):
                rep.conn.send(("stop",))
            rep.process.join(5.0)
            if rep.process.is_alive():
                rep.process.kill()
                rep.process.join(5.0)
            rep.conn.close()
        with self._lock:
            if rep.lease is not None:
                rep.lease.release()
                rep.lease = None
            rep.state = "DEAD"

    def _health_check(self, qname: str, info: DeploymentInfo) -> None:
        now = time.monotonic()
        if now - self._last_health_check.get(qname, 0.0) < info.config.health_check_period_s:
            return
        self._last_health_check[qname] = now
        with self._lock:
            running = [r for r in self._replicas.get(qname, []) if r.state == "RUNNING"]
        for rep in running:
            result = self._call(rep, "check_health", timeout=info.config.health_check_timeout_s)
            if result == "ok":
                continue
            # No answer: stop it. "draining": it drains on its own
            # (SIGTERM). Either way it leaves, and the next pass replaces it.
            with self._lock:
                if rep in self._replicas.get(qname, []):
                    self._replicas[qname].remove(rep)
            self._stop_replica(rep, timeout_s=(0.0 if result is None
                                               else info.config.graceful_shutdown_timeout_s))

    def _autoscale(self, qname: str, info: DeploymentInfo) -> None:
        state = self._autoscalers.get(qname)
        if state is None:
            return
        with self._lock:
            running = [r for r in self._replicas.get(qname, []) if r.state == "RUNNING"]
        loads = _channel.run_sync(_gather_loads([r.address for r in running]), timeout=10)
        current = self._autoscale_counts.get(qname, info.config.autoscaling_config.min_replicas)
        # The proxies' route p99 (the slow tick's scrape) turns a breached
        # latency target into one more replica.
        decision = state.decide(sum(load.get("ongoing", 0) for load in loads), current,
                                queue_depth=sum(load.get("queue_depth", 0) for load in loads),
                                p99_ms=self.get_route_p99().get(qname))
        if decision != current:
            with self._lock:
                self._autoscale_counts[qname] = decision

    @staticmethod
    def _version_of(spec: dict) -> str:
        """Code and argument identity only: scaling or a new user_config
        must not roll replicas (user_config reconfigures in place)."""
        target = spec["cls_or_fn"]
        try:
            blob = pickle.dumps((spec["name"], target.__module__, target.__qualname__,
                                 spec.get("init_args"), spec.get("init_kwargs")))
        except (pickle.PicklingError, TypeError, AttributeError):
            blob = repr(spec).encode()
        return hashlib.sha1(blob).hexdigest()[:8]


async def _channel_call(address, method: str, *args) -> Any:
    return await _channel.peer(address).call(method, *args)


async def _gather_loads(addresses: list) -> list[dict]:
    """Each replica's load; a replica that does not answer in 5 s counts
    as none."""
    async def one(address):
        try:
            return await asyncio.wait_for(_channel_call(address, "get_load"), 5.0)
        except (ConnectionError, asyncio.TimeoutError, _channel.RemoteError):
            return {}
    return list(await asyncio.gather(*(one(a) for a in addresses)))


def _log_failure(future) -> None:
    if not future.cancelled() and future.exception() is not None:
        print(f"serve: a call to a replica failed: {future.exception()!r}", file=sys.stderr,
              flush=True)
