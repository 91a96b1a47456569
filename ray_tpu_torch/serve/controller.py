"""ServeController: the reconciler of applications, deployments and replicas.

Port of ray_tpu's ``serve/_private/controller.py``. It runs in a detached
named actor (``SERVE_CONTROLLER``, ``max_concurrency=256``) on the
runtime, with its reconcile loop on a thread of its own. It holds the
target state (applications, their deployments and routes) and every
0.25 s starts and stops replica actors to match each deployment's target,
replaces replicas whose actor died or whose health check failed, rolls
replicas of an older version, drains replicas before it kills them, and
autoscales from the replicas' ongoing and queued counts, the proxies'
route p99 and the serve-LLM decode replicas' KV headroom (the worst
replica's free fraction). One ``list_actors`` call a pass reads every
replica's state from the runtime: a dead replica is replaced at the next
pass, and a replica the node agent cannot place yet shows as PENDING. A
second thread, every second, health-checks the proxies registered with
it, restarts a dead one under its name and port as a detached actor, and
scrapes their per-route latencies. Membership (routes, running replicas
by actor name, each deployment's policy, the proxies) reaches routers
through ``poll_update``, an async method parked on the actor's loop.

A replica is ``ray_tpu_torch.remote(Replica).options(name="SERVE_REPLICA::<id>",
max_concurrency=max(8, max_ongoing_requests), num_cpus=, num_gpus=,
resources=)``: ``ray_actor_options={"num_gpus": g}`` leases a share of a
card from the node agent, which sets the replica's ``CUDA_VISIBLE_DEVICES``
(two replicas at 0.5 share one card); ``num_tpus`` leases the ``TPU`` key.
The target state and the proxies are checkpointed in the runtime
controller's KV (namespace ``serve``) at every deploy, delete and proxy
registration; a controller that starts again restores them and takes back
the replica actors still alive (by their names), killing those of
deployments it no longer has. The drains on the node agent's out-of-memory telemetry wait
for ROADMAP Queue A item 14d and raise ``NotImplementedError`` naming it.

The controller imports no torch: user classes travel as ``CallableRef``.
"""

from __future__ import annotations

import hashlib
import logging
import pickle
import sys
import threading
import time
import traceback
import uuid
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._common import (
    RUNTIME_CORE_ITEM, DeploymentInfo, ReplicaInfo, new_replica_id,
)
from ray_tpu_torch.serve.autoscaling_policy import AutoscalingState
from ray_tpu_torch.util import metrics as metrics_mod

RECONCILE_PERIOD_S = 0.25
# Proxy liveness and the route-p99 scrape run on a slower tick.
PROXY_CHECK_PERIOD_S = 1.0
# A replica's constructor may build kernels and warm every batch bucket.
READY_TIMEOUT_S = 900.0
# Replicas of a deployment that fail to start this many times in a row
# stop being replaced, and its application reports DEPLOY_FAILED.
MAX_START_FAILURES = 3

logger = logging.getLogger(__name__)


def _kv_call(method: str, payload: dict) -> Any:
    from ray_tpu_torch._private import worker as worker_mod

    ctx = worker_mod.get_global_context()
    return ctx.io.run(ctx.controller.call(method, payload))


def _call(actor, method: str, *args, timeout: float = 5.0) -> Any:
    """The actor's ``method``, or None if it failed or timed out."""
    try:
        return ray_tpu_torch.get(getattr(actor, method).remote(*args), timeout=timeout)
    except Exception:
        return None


def _kill(actor) -> None:
    try:
        ray_tpu_torch.kill(actor)
    except Exception:
        pass  # already dead


def actor_options(options: dict, name: str, max_concurrency: int) -> dict:
    """A replica's actor options from its ``ray_actor_options``."""
    out = {"name": name, "max_concurrency": max_concurrency,
           "num_cpus": options.get("num_cpus", 1)}
    if options.get("num_gpus"):
        out["num_gpus"] = float(options["num_gpus"])
    resources = {key: float(amount) for key, amount in (options.get("resources") or {}).items()}
    if options.get("num_tpus"):
        resources["TPU"] = resources.get("TPU", 0.0) + float(options["num_tpus"])
    if resources:
        out["resources"] = resources
    return out


class _Proxy:
    """A proxy registered with the controller, by its actor's name."""

    def __init__(self, name: str, protocol: str, host: str, port: int):
        self.name, self.protocol, self.host, self.port = name, protocol, host, int(port)
        self.restarts = 0
        self.pid: Optional[int] = None

    def describe(self) -> dict:
        return {"name": self.name, "protocol": self.protocol, "host": self.host,
                "port": self.port, "restarts": self.restarts, "pid": self.pid}


class _Replica:
    """The controller's record of one replica and its actor."""

    def __init__(self, info: ReplicaInfo):
        self.info = info
        self.actor = None

    @property
    def state(self) -> str:
        return self.info.state

    @state.setter
    def state(self, value: str) -> None:
        self.info.state = value


class ServeController:
    """Hosted in a detached named actor (max_concurrency > 1)."""

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
        self._route_inflight: dict[str, int] = {}
        self._actor_states: dict[str, dict] = {}
        self._version = 0
        self._instance = uuid.uuid4().hex
        self._snapshot: Optional[dict] = None
        self._pollers: set = set()
        self._stopped = threading.Event()
        self._restore_checkpoint()
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
                            # A failure is the health check's to find.
                            rep.actor.reconfigure.remote(info.config.user_config)
            for qname in self._app_deployments.get(app_name, []):
                if qname not in new_names:
                    self._deployments.pop(qname, None)
                    self._last_health_check.pop(qname, None)
            self._app_deployments[app_name] = new_names
            self._app_status[app_name] = "DEPLOYING"
            if route_prefix is not None and deployments:
                self._routes[route_prefix] = f"{app_name}_{deployments[-1]['name']}"
            self._bump_version_locked()
        self._save_checkpoint()
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
        self._save_checkpoint()
        return "ok"

    def shutdown(self, timeout_s: float = 30.0) -> str:
        """Stops the reconcile loop, every replica (draining each up to its
        graceful timeout, capped by ``timeout_s``) and every proxy, and
        clears the checkpoint."""
        with self._lock:
            self._deployments.clear()
            self._routes.clear()
            self._app_deployments.clear()
            self._app_status.clear()
            self._bump_version_locked()
        self._save_checkpoint()
        self._stopped.set()
        self._thread.join(timeout=10)
        self._proxy_thread.join(timeout=10)
        with self._lock:
            replicas = [r for reps in self._replicas.values() for r in reps]
            self._replicas.clear()
            proxies, self._proxies = list(self._proxies.values()), {}
        stoppers = [self._stop_replica(r, timeout_s=min(timeout_s, 5.0)) for r in replicas]
        for stopper in stoppers:
            if stopper is not None:
                stopper.join(timeout_s)
        for proxy in proxies:
            try:
                _kill(ray_tpu_torch.get_actor(proxy.name))
            except ValueError:
                pass
        self._notify_pollers()
        return "ok"

    def ping(self) -> str:
        return "ok"

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def get_routes(self) -> dict:
        with self._lock:
            return dict(self._routes)

    def membership(self) -> dict:
        """Routes, each deployment's running replicas (their actor names)
        and policy, and the proxies. Recomputed only when the version
        moves."""
        with self._lock:
            if self._snapshot is None:
                replicas = {}
                for qname, info in self._deployments.items():
                    running = sorted(r.info.actor_name for r in self._replicas.get(qname, [])
                                     if r.state == "RUNNING")
                    replicas[qname] = {
                        "actor_names": running,
                        "max_ongoing_requests": info.config.max_ongoing_requests,
                        "policy": info.config.policy_snapshot(),
                    }
                self._snapshot = {"routes": dict(self._routes), "replicas": replicas,
                                  "proxies": [{k: v for k, v in p.describe().items()
                                               if k in ("name", "protocol", "host", "port")}
                                              for p in self._proxies.values()]}
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

    def get_metrics(self) -> dict:
        """Each deployment's running replicas' metrics, asked of all at once."""
        with self._lock:
            running = {q: [r for r in reps if r.state == "RUNNING"]
                       for q, reps in self._replicas.items()}
        refs = {q: [r.actor.get_metrics.remote() for r in reps] for q, reps in running.items()}
        out = {}
        for qname, pending in refs.items():
            out[qname] = []
            for ref in pending:
                try:
                    out[qname].append(ray_tpu_torch.get(ref, timeout=10))
                except Exception:
                    pass  # a replica dying meanwhile
        return out

    # ------------------------------------------------------------------
    # the proxies
    # ------------------------------------------------------------------
    def register_proxy(self, name: str, protocol: str, host: str, port: int) -> str:
        """serve.start() reports each proxy actor it started; from then on
        the controller restarts it under the same name and port when it
        dies."""
        proxy = _Proxy(name, protocol, host, port)
        proxy.pid = self._actor_pid(name)
        with self._lock:
            old = self._proxies.get(name)
            if old is not None:
                proxy.restarts = old.restarts
            self._proxies[name] = proxy
            self._bump_version_locked()
        self._save_checkpoint()
        return "ok"

    def unregister_proxy(self, name: str) -> str:
        with self._lock:
            self._proxies.pop(name, None)
            self._bump_version_locked()
        self._save_checkpoint()
        return "ok"

    def get_proxies(self) -> list:
        with self._lock:
            return [p.describe() for p in self._proxies.values()]

    def proxy_call(self, name: str, method: str, timeout: float = 10.0) -> Any:
        """A registered proxy's ``method`` (``get_route_stats``,
        ``get_num_requests``, ``get_reliability_stats``), or None if it did
        not answer."""
        try:
            return _call(ray_tpu_torch.get_actor(name), method, timeout=timeout)
        except ValueError:
            return None

    def _actor_pid(self, name: str) -> Optional[int]:
        for snap in self._list_actors().values():
            if snap.get("name") == name and snap.get("state") == "ALIVE":
                return snap.get("pid")
        return None

    def _ensure_proxies(self) -> None:
        """Health-checks each proxy; restarts a dead one under the same name
        and port, so that clients holding its address recover."""
        with self._lock:
            proxies = list(self._proxies.values())
        for proxy in proxies:
            if self.proxy_call(proxy.name, "get_num_requests", timeout=5.0) is not None:
                continue
            print(f"serve: proxy {proxy.name} is down; restarting it", file=sys.stderr,
                  flush=True)
            try:
                from ray_tpu_torch.serve.api import start_proxy_actor

                start_proxy_actor(proxy.protocol, proxy.host, proxy.port)
            except Exception:
                # The name or the port may not be free yet; the next tick
                # tries again.
                traceback.print_exc()
                continue
            metrics_mod.inc_serve_reliability("proxy_restarts", proxy=proxy.name)
            with self._lock:
                proxy.restarts += 1
                proxy.pid = self._actor_pid(proxy.name)
                if self._proxies.get(proxy.name) is not proxy:
                    # Unregistered, or serve shut down, meanwhile.
                    try:
                        _kill(ray_tpu_torch.get_actor(proxy.name))
                    except ValueError:
                        pass

    def _scrape_route_p99(self) -> None:
        """Each HTTP proxy's per-route p99 for the autoscaler (a route that
        several proxies serve reports its worst) and the requests of each
        route the proxies hold (summed)."""
        with self._lock:
            names = [p.name for p in self._proxies.values() if p.protocol == "http"]
        merged: dict[str, float] = {}
        inflight: dict[str, int] = {}
        for name in names:
            for route, snap in (self.proxy_call(name, "get_route_stats", timeout=5.0)
                                or {}).items():
                merged[route] = max(merged.get(route, 0.0), snap["p99_ms"])
                inflight[route] = inflight.get(route, 0) + snap.get("inflight", 0)
        with self._lock:
            self._route_p99.update(merged)
            self._route_inflight = inflight

    def _proxy_loop(self) -> None:
        while not self._stopped.wait(PROXY_CHECK_PERIOD_S):
            try:
                self._ensure_proxies()
                self._scrape_route_p99()
            except Exception:
                traceback.print_exc()

    # ------------------------------------------------------------------
    # the checkpoint in the runtime controller's KV, and what waits
    # ------------------------------------------------------------------
    def _save_checkpoint(self) -> None:
        with self._lock:
            state = {"deployments": self._deployments, "routes": self._routes,
                     "app_deployments": self._app_deployments,
                     "proxies": [p.describe() for p in self._proxies.values()]}
            value = pickle.dumps(state)
        try:
            _kv_call("kv_put", {"namespace": "serve", "key": "controller_checkpoint",
                                "value": value, "overwrite": True})
        except Exception:
            # A lost checkpoint bites only on a restart: say so now.
            logger.warning("controller checkpoint save failed", exc_info=True)

    def _restore_checkpoint(self) -> None:
        try:
            resp = _kv_call("kv_get", {"namespace": "serve", "key": "controller_checkpoint"})
            if resp.get("status") == "ok" and resp.get("value"):
                state = pickle.loads(resp["value"])
                with self._lock:
                    self._deployments = state["deployments"]
                    self._routes = state["routes"]
                    self._app_deployments = state["app_deployments"]
                    for qname, info in self._deployments.items():
                        self._replicas.setdefault(qname, [])
                        if info.config.autoscaling_config:
                            self._autoscalers[qname] = AutoscalingState(
                                info.config.autoscaling_config)
                    for app in self._app_deployments:
                        self._app_status[app] = "DEPLOYING"
                    for desc in state.get("proxies", []):
                        proxy = self._proxies[desc["name"]] = _Proxy(
                            desc["name"], desc["protocol"], desc["host"], desc["port"])
                        proxy.restarts = desc["restarts"]
                    self._bump_version_locked()
                self._adopt_replicas()
        except Exception:
            logger.warning("controller checkpoint restore failed; starting with an empty "
                           "target state", exc_info=True)

    def _adopt_replicas(self) -> None:
        """Takes back the live replica actors of the restored deployments
        (their names carry their deployment) and kills the others."""
        for snap in self._list_actors().values():
            name = snap.get("name") or ""
            if snap.get("state") != "ALIVE" or not name.startswith("SERVE_REPLICA::"):
                continue
            replica_id = name.split("::", 1)[1]
            qname = replica_id.rsplit("#", 1)[0]
            try:
                actor = ray_tpu_torch.get_actor(name)
            except ValueError:
                continue
            with self._lock:
                info = self._deployments.get(qname)
                if info is not None:
                    rep = _Replica(ReplicaInfo(replica_id=replica_id, deployment=qname,
                                               actor_name=name, state="RUNNING",
                                               version=info.version))
                    rep.actor = actor
                    self._replicas.setdefault(qname, []).append(rep)
            if info is None:
                _kill(actor)

    def _drain_oom_flagged(self) -> None:
        raise NotImplementedError(f"drains on the node agent's oom_risk telemetry wait for the "
                                  f"node agent's telemetry ({RUNTIME_CORE_ITEM})")

    # ------------------------------------------------------------------
    # the membership (long poll)
    # ------------------------------------------------------------------
    def _bump_version_locked(self) -> None:
        self._version += 1
        self._snapshot = None
        self._notify_pollers()

    def _notify_pollers(self) -> None:
        for loop, event in list(self._pollers):
            try:
                loop.call_soon_threadsafe(event.set)
            except RuntimeError:
                pass  # the poller's loop closed; its next poll registers again

    async def poll_update(self, last_version: int = -1, timeout_s: float = 10.0) -> dict:
        """Answers when the membership version passes ``last_version`` (or
        after ``timeout_s``) with the snapshot. Async, so that a parked
        poll holds no thread of the actor."""
        import asyncio

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

    def _list_actors(self) -> dict:
        """The runtime's actors by id: state, pid, name, death cause."""
        try:
            return {a["actor_id"]: a for a in _kv_call("list_actors", {})}
        except Exception:
            return {}

    def _reconcile_once(self) -> None:
        self._actor_states = self._list_actors()
        with self._lock:
            targets = dict(self._deployments)
            gone = [self._replicas.pop(q) for q in list(self._replicas) if q not in targets]
        for rep in (r for reps in gone for r in reps):
            self._stop_replica(rep, timeout_s=5.0, trigger="app_delete")
        for qname, info in targets.items():
            self._autoscale(qname, info)
            self._reconcile_deployment(qname, info)
            self._health_check(qname, info)

    def _runtime_state(self, rep: _Replica) -> Optional[str]:
        if rep.actor is None:
            return None
        snap = self._actor_states.get(rep.actor._actor_id)
        return snap.get("state") if snap else None

    def _reconcile_deployment(self, qname: str, info: DeploymentInfo) -> None:
        """One deployment's pass: roll old versions, reap dead replicas and
        start or stop replicas to the target."""
        target = self._target_count(qname, info)
        with self._lock:
            replicas = self._replicas.setdefault(qname, [])
            stale = [r for r in replicas if r.info.version != info.version]
            dead = [r for r in replicas if r.state == "DEAD"
                    or (r.state == "RUNNING" and self._runtime_state(r) == "DEAD")]
            for rep in stale + [r for r in dead if r not in stale]:
                replicas.remove(rep)
        for rep in stale:
            self._stop_replica(rep, timeout_s=info.config.graceful_shutdown_timeout_s,
                               trigger="rolling_update")
        for rep in dead:
            # A kill or a crash, not a drain; this pass starts the replacement.
            self._stop_replica(rep, timeout_s=0.0, trigger=None)
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
            self._stop_replica(rep, timeout_s=info.config.graceful_shutdown_timeout_s,
                               trigger="scale_down")
        for _ in range(missing):
            replica_id = new_replica_id(qname)
            rep = _Replica(ReplicaInfo(replica_id=replica_id, deployment=qname,
                                       actor_name=f"SERVE_REPLICA::{replica_id}",
                                       state="PENDING", version=info.version))
            with self._lock:
                replicas.append(rep)
            self._start_replica(rep, info)

    def _start_replica(self, rep: _Replica, info: DeploymentInfo) -> None:
        from ray_tpu_torch.serve.replica import Replica

        options = actor_options(info.config.ray_actor_options, rep.info.actor_name,
                                max(8, info.config.max_ongoing_requests))
        try:
            rep.actor = ray_tpu_torch.remote(Replica).options(**options).remote(
                rep.info.replica_id, info.qualified_name(), info.cls_or_fn, info.init_args,
                info.init_kwargs, info.config.user_config, info.version,
                limits=info.config.policy_snapshot())
        except Exception:
            with self._lock:
                self._start_failures.setdefault(rep.info.deployment, []).append(
                    traceback.format_exc())
                rep.state = "DEAD"
            return
        rep.info.started_at = time.time()
        threading.Thread(target=self._await_ready, args=(rep,), daemon=True).start()

    def _await_ready(self, rep: _Replica) -> None:
        """PENDING while the node agent cannot place the actor, STARTING
        while it builds, RUNNING when its first health check answers; DEAD
        if its constructor raised or it died first."""
        from ray_tpu_torch import exceptions

        qname = rep.info.deployment
        deadline = time.monotonic() + READY_TIMEOUT_S
        ref = rep.actor.check_health.remote()
        reason = None
        while True:
            ready, _ = ray_tpu_torch.wait([ref], timeout=0.25)
            if ready:
                try:
                    ray_tpu_torch.get(ref, timeout=30)
                    break
                except exceptions.ActorUnavailableError:
                    # Still waiting for a place past the runtime's wait.
                    ref = rep.actor.check_health.remote()
                    continue
                except Exception as exc:
                    reason = str(exc)
                    break
            snap = self._actor_states.get(rep.actor._actor_id, {})
            with self._lock:
                if rep.state not in ("PENDING", "STARTING"):
                    return  # stopped while it started
                if snap.get("state") == "ALIVE" and rep.state == "PENDING":
                    rep.state = "STARTING"
            if time.monotonic() > deadline:
                reason = f"replica not ready after {READY_TIMEOUT_S:.0f} s"
                break
        with self._lock:
            if rep.state not in ("PENDING", "STARTING"):
                return
            if reason is None:
                rep.state = "RUNNING"
                rep.info.node_id = _call(rep.actor, "get_node_id", timeout=10) or ""
                self._start_failures.pop(qname, None)
            else:
                print(f"serve: replica {rep.info.replica_id} failed to start:\n{reason}",
                      file=sys.stderr, flush=True)
                self._start_failures.setdefault(qname, []).append(reason)
                rep.state = "DEAD"
            self._bump_version_locked()
        if reason is not None:
            _kill(rep.actor)

    def _stop_replica(self, rep: _Replica, timeout_s: float = 20.0,
                      trigger: Optional[str] = "scale_down") -> Optional[threading.Thread]:
        """Drain, then kill: the replica leaves the membership at once,
        finishes what it holds up to ``timeout_s`` (checkpointing its
        multiplexed models in ``drain``), and its actor is killed. A drain
        counts under its ``trigger``; a dead replica's reaping (None) does
        not."""
        with self._lock:
            was = rep.state
            rep.state = "DRAINING"
            if was == "RUNNING":
                self._bump_version_locked()  # out of the membership now
        if rep.actor is None:
            rep.state = "DEAD"
            return None
        if trigger:
            metrics_mod.inc_serve_reliability("drains", deployment=rep.info.deployment,
                                              trigger=trigger)

        def stop():
            if was == "RUNNING" and timeout_s > 0:
                _call(rep.actor, "drain", timeout=10)
                deadline = time.monotonic() + timeout_s
                while time.monotonic() < deadline:
                    if not _call(rep.actor, "get_num_ongoing"):
                        break
                    time.sleep(0.1)
            _kill(rep.actor)
            rep.state = "DEAD"

        thread = threading.Thread(target=stop, daemon=True)
        thread.start()
        return thread

    def _health_check(self, qname: str, info: DeploymentInfo) -> None:
        now = time.monotonic()
        if now - self._last_health_check.get(qname, 0.0) < info.config.health_check_period_s:
            return
        self._last_health_check[qname] = now
        with self._lock:
            running = [r for r in self._replicas.get(qname, []) if r.state == "RUNNING"]
        refs = [(rep, rep.actor.check_health.remote()) for rep in running]
        for rep, ref in refs:
            try:
                result = ray_tpu_torch.get(ref, timeout=info.config.health_check_timeout_s)
            except Exception:
                result = None
            if result == "ok":
                continue
            # No answer: stop it. "draining": it drains on its own
            # (SIGTERM). Either way it leaves, and the next pass replaces it.
            with self._lock:
                if rep in self._replicas.get(qname, []):
                    self._replicas[qname].remove(rep)
            self._stop_replica(rep, timeout_s=(0.0 if result is None
                                               else info.config.graceful_shutdown_timeout_s),
                               trigger=None if result is None else "sigterm")

    def _autoscale(self, qname: str, info: DeploymentInfo) -> None:
        state = self._autoscalers.get(qname)
        if state is None:
            return
        with self._lock:
            running = [r for r in self._replicas.get(qname, []) if r.state == "RUNNING"]
        refs = [r.actor.get_load.remote() for r in running]
        loads = []
        for ref in refs:
            try:
                loads.append(ray_tpu_torch.get(ref, timeout=5))
            except Exception:
                loads.append({})  # a replica that does not answer counts as none
        current = self._autoscale_counts.get(qname, info.config.autoscaling_config.min_replicas)
        # Serve-LLM decode replicas report their KV pool's headroom; the
        # pool scales on its worst replica, since one full pool stalls that
        # replica's admission however idle the others are.
        fracs = [load["kv_free_frac"] for load in loads if load.get("kv_free_frac") is not None]
        # The requests the route's proxies hold count as ongoing when they
        # are more than the replicas hold: an ingress that queues them hides
        # the demand from the replicas. The proxies' route p99 (the slow
        # tick's scrape) turns a breached latency target into one more
        # replica.
        with self._lock:
            held = self._route_inflight.get(qname, 0)
        ongoing = max(sum(load.get("ongoing", 0) for load in loads), held)
        decision = state.decide(ongoing, current,
                                queue_depth=sum(load.get("queue_depth", 0) for load in loads),
                                p99_ms=self.get_route_p99().get(qname),
                                kv_free_frac=min(fracs) if fracs else None)
        if decision != current:
            with self._lock:
                self._autoscale_counts[qname] = decision

    @staticmethod
    def _version_of(spec: dict) -> str:
        """Code and argument identity only: scaling or a new user_config
        must not roll replicas (user_config reconfigures in place)."""
        target = spec["cls_or_fn"]
        try:
            blob = pickle.dumps((spec["name"], target.module, target.qualname,
                                 spec.get("init_args"), spec.get("init_kwargs")))
        except (pickle.PicklingError, TypeError, AttributeError):
            blob = repr(spec).encode()
        return hashlib.sha1(blob).hexdigest()[:8]
