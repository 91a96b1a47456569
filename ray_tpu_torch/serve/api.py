"""The public serve API: ``@serve.deployment``, ``.bind()``, ``serve.run``.

Port of ray_tpu's ``serve/api.py``. ``Deployment.bind(...)`` builds an
application graph (bound sub-deployments become handles when the replica
is built); ``serve.run`` hands the graph to the controller, waits until
every deployment has its replicas running, and returns the ingress
handle. Like the reference's, serve runs on the runtime and needs
``ray_tpu_torch.init()`` first: ``serve.start`` gets or creates the
controller (a detached actor named ``SERVE_CONTROLLER``), the HTTP proxy
on ``http_port`` and ``num_proxies - 1`` more on the next ports (detached
actors named ``SERVE_PROXY::<port>``, which the controller health-checks
and restarts under their names and ports), and with ``grpc_port`` the
gRPC proxy, and returns the controller's actor handle.
``serve.run_from_config`` deploys the applications a YAML file (or its
dict) describes (``schema``). ``serve.shutdown`` stops the replicas and
kills the controller and the proxies.

A deployment's class or function must be importable from a module (its
replicas import it by name: the serve plane depends on no cloudpickle),
and so must every argument it is bound with pickle.
``ray_actor_options={"num_gpus": g}`` leases each replica a share of a
card from the node agent; ``num_cpus``, ``num_tpus`` and ``resources``
lease their keys from it too, and a replica the agent cannot place yet
waits as PENDING. ``serve.run`` refuses a deployment that asks for more
cards than the cluster has, and one that asks for a card in a cluster
with none. ``autoscaling_config={"kv_headroom_min": f}`` scales a
serve-LLM decode pool (``serve.llm``) up while its worst replica's KV pool
has less than ``f`` of its blocks free.
"""

from __future__ import annotations

import copy
import pickle
import threading
import time
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch.serve import long_poll
from ray_tpu_torch.serve._common import (
    CONTROLLER_NAME, DEFAULT_APP_NAME, AutoscalingConfig, DeploymentConfig, RetryPolicy,
)
from ray_tpu_torch.serve.handle import DeploymentHandle, _HandlePlaceholder

# The proxies this process started: (protocol, port) -> actor handle, and
# the first HTTP proxy's port.
_proxies: dict[tuple, Any] = {}
_proxies_lock = threading.Lock()
_primary_port: Optional[int] = None


class Application:
    """A bound deployment graph node."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def _collect(self, app_name: str, seen: dict) -> list[dict]:
        """Deployment specs, dependencies first."""
        specs: list[dict] = []

        def resolve(obj: Any) -> Any:
            if isinstance(obj, Application):
                for spec in obj._collect(app_name, seen):
                    if spec["name"] not in [s["name"] for s in specs]:
                        specs.append(spec)
                return _HandlePlaceholder(obj.deployment.name, app_name)
            if isinstance(obj, tuple):
                return tuple(resolve(x) for x in obj)
            if isinstance(obj, list):
                return [resolve(x) for x in obj]
            if isinstance(obj, dict):
                return {k: resolve(v) for k, v in obj.items()}
            return obj

        if self.deployment.name in seen:
            return specs
        seen[self.deployment.name] = True
        init_args = resolve(self.args)
        init_kwargs = resolve(self.kwargs)
        from ray_tpu_torch.serve.replica import CallableRef

        specs.append({
            "name": self.deployment.name,
            "cls_or_fn": CallableRef(self.deployment.func_or_class),
            "init_args": init_args, "init_kwargs": init_kwargs,
            "config": self.deployment._config, "route_prefix": self.deployment._route_prefix,
        })
        return specs


# The replica options the controller reads, as the reference's does.
ACTOR_OPTIONS = frozenset({"num_gpus", "num_cpus", "num_tpus", "resources"})


def _check_config(config: DeploymentConfig) -> DeploymentConfig:
    """Refuses what no replica could be given."""
    options = dict(config.ray_actor_options)
    unknown = set(options) - ACTOR_OPTIONS
    if unknown:
        raise ValueError(f"ray_actor_options {sorted(unknown)}: replicas take "
                         f"{sorted(ACTOR_OPTIONS)}")
    if not isinstance(options.get("resources") or {}, dict):
        raise ValueError("ray_actor_options['resources'] is a dict of amounts")
    gpus = float(options.get("num_gpus", 0) or 0)
    if gpus < 0 or (gpus > 1 and gpus != int(gpus)):
        raise ValueError(f"num_gpus must be a share of one card or a whole number, got {gpus}")
    return config


class Deployment:
    def __init__(self, func_or_class: Any, name: str, config: DeploymentConfig,
                 route_prefix: Optional[str] = None):
        self.func_or_class = func_or_class
        self.name = name
        self._config = _check_config(config)
        self._route_prefix = route_prefix

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, **overrides) -> "Deployment":
        config = copy.deepcopy(self._config)
        route_prefix = overrides.pop("route_prefix", self._route_prefix)
        name = overrides.pop("name", self.name)
        for key, value in overrides.items():
            if key == "autoscaling_config" and isinstance(value, dict):
                value = AutoscalingConfig(**value)
            if key == "retry_policy" and isinstance(value, dict):
                value = RetryPolicy.from_dict(value)
            if not hasattr(config, key):
                raise TypeError(f"unknown deployment option {key!r}")
            setattr(config, key, value)
        return Deployment(self.func_or_class, name, config, route_prefix)

    def __repr__(self):
        return f"Deployment({self.name})"


def deployment(
    _func_or_class: Any = None,
    *,
    name: Optional[str] = None,
    num_replicas: int | str | None = None,
    max_ongoing_requests: int = 100,
    user_config: Any = None,
    autoscaling_config: AutoscalingConfig | dict | None = None,
    ray_actor_options: dict | None = None,
    health_check_period_s: float = 10.0,
    health_check_timeout_s: float = 30.0,
    route_prefix: Optional[str] = None,
    request_timeout_s: float = 60.0,
    health_probe_timeout_s: float = 5.0,
    max_queued_requests: int = -1,
    retry_policy: RetryPolicy | dict | None = None,
    graceful_shutdown_timeout_s: float = 20.0,
):
    """@serve.deployment, with the reference decorator's arguments."""

    def wrap(target):
        asc = (AutoscalingConfig(**autoscaling_config) if isinstance(autoscaling_config, dict)
               else autoscaling_config)
        policy = (RetryPolicy.from_dict(retry_policy) if isinstance(retry_policy, dict)
                  else retry_policy or RetryPolicy())
        n_replicas = num_replicas
        if n_replicas == "auto":
            n_replicas = None
            asc = asc or AutoscalingConfig()
        config = DeploymentConfig(
            num_replicas=n_replicas or 1, max_ongoing_requests=max_ongoing_requests,
            user_config=user_config, autoscaling_config=asc,
            ray_actor_options=ray_actor_options or {},
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s, request_timeout_s=request_timeout_s,
            health_probe_timeout_s=health_probe_timeout_s,
            max_queued_requests=max_queued_requests, retry_policy=policy,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s)
        return Deployment(target, name or getattr(target, "__name__", "deployment"), config,
                          route_prefix)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


# ---------------------------------------------------------------------------
# the cluster-facing API
# ---------------------------------------------------------------------------
def _get_controller():
    """The running controller's handle; ValueError if there is none."""
    return ray_tpu_torch.get_actor(CONTROLLER_NAME)


def _get_or_create_controller():
    from ray_tpu_torch.serve.controller import ServeController

    try:
        return _get_controller()
    except ValueError:
        pass
    try:
        # Every serve process keeps one async poll_update parked here.
        return ray_tpu_torch.remote(ServeController).options(
            name=CONTROLLER_NAME, lifetime="detached", max_concurrency=256).remote()
    except ValueError:
        return _get_controller()  # raced with another creator


def _get(ref, timeout: float = 60.0):
    return ray_tpu_torch.get(ref, timeout=timeout)


def _proxy_name(protocol: str, port: int) -> str:
    """A proxy's actor name, the reference's."""
    return f"SERVE_{'GRPC_' if protocol == 'grpc' else ''}PROXY::{port}"


def start_proxy_actor(protocol: str, host: str, port: int):
    """Gets or creates the proxy actor for ``(protocol, port)``, race-safe
    by its name, and waits until it serves. The controller restarts a dead
    proxy through here."""
    if protocol == "grpc":
        from ray_tpu_torch.serve.grpc_proxy import GRPCProxy as proxy_cls
    else:
        from ray_tpu_torch.serve.proxy import HTTPProxy as proxy_cls
    name = _proxy_name(protocol, port)
    try:
        handle = ray_tpu_torch.get_actor(name)
    except ValueError:
        try:
            handle = ray_tpu_torch.remote(proxy_cls).options(
                name=name, lifetime="detached", max_concurrency=64).remote(host, port)
        except ValueError:
            handle = ray_tpu_torch.get_actor(name)  # raced with another creator
    _get(handle.ready.remote(), timeout=120)
    return handle


def _ensure_proxy(controller, protocol: str, host: str, port: int) -> None:
    """The proxy on ``port``, started and registered with the controller,
    which health-checks it and restarts it on death."""
    with _proxies_lock:
        if (protocol, port) in _proxies:
            return
    handle = start_proxy_actor(protocol, host, port)
    _get(controller.register_proxy.remote(_proxy_name(protocol, port), protocol, host, port),
         timeout=30)
    with _proxies_lock:
        _proxies[(protocol, port)] = handle


def _drop_proxies(controller, protocol: str, keep: set) -> None:
    """Kills this process's proxies of ``protocol`` on ports not in ``keep``
    (a new port replaces the proxy on the old one)."""
    with _proxies_lock:
        gone = [(key, h) for key, h in _proxies.items() if key[0] == protocol
                and key[1] not in keep]
        for key, _ in gone:
            _proxies.pop(key)
    for (proto, port), handle in gone:
        _get(controller.unregister_proxy.remote(_proxy_name(proto, port)), timeout=30)
        _kill_quietly(handle)


def _kill_quietly(handle) -> None:
    if handle is not None:
        try:
            ray_tpu_torch.kill(handle)
        except Exception:
            pass  # already dead


def start(http_host: str = "127.0.0.1", http_port: Optional[int] = 8000,
          grpc_port: Optional[int] = None, num_proxies: int = 1):
    """Starts the controller and an HTTP proxy on ``http_port`` (None: no
    HTTP proxy change), and ``num_proxies - 1`` more on the ports after it;
    clients fail over between them. ``grpc_port`` starts the gRPC proxy. A
    new port replaces the proxy on the old one. Every proxy is registered
    with the controller, which restarts it when it dies and scrapes its
    route latencies for the autoscaler. Needs ``ray_tpu_torch.init()``;
    returns the controller's actor handle."""
    global _primary_port
    controller = _get_or_create_controller()
    if http_port is not None:
        if _primary_port not in (None, http_port):
            _drop_proxies(controller, "http", set())
        _primary_port = http_port
        for port in range(http_port, http_port + max(1, num_proxies)):
            _ensure_proxy(controller, "http", http_host, port)
    if grpc_port is not None:
        _drop_proxies(controller, "grpc", {grpc_port})
        _ensure_proxy(controller, "grpc", http_host, grpc_port)
    return controller


def _seal_specs(specs: list[dict]) -> None:
    """Refuses, before anything starts, a deployment whose arguments do not
    pickle, and one asking for more cards than the cluster has. Seals each
    deployment's init arguments into one pickle that only its replicas
    open: the controller never loads the user's objects (a torch dtype
    among them would import torch into it)."""
    cards = float(ray_tpu_torch.cluster_resources().get("GPU", 0))
    for spec in specs:
        try:
            pickle.dumps(spec["config"].user_config)
            spec["init_args"] = pickle.dumps((spec["init_args"], spec["init_kwargs"]))
            spec["init_kwargs"] = None
        except (pickle.PicklingError, TypeError, AttributeError) as exc:
            raise TypeError(f"deployment {spec['name']!r}: its arguments must pickle, since "
                            f"each replica is an actor of its own: {exc}") from exc
        want = float(spec["config"].ray_actor_options.get("num_gpus", 0) or 0)
        if want > 0 and cards == 0:
            raise RuntimeError(
                f"deployment {spec['name']!r} asks for num_gpus={want} and this cluster has "
                f"no CUDA device; a replica without a card sets num_gpus=0")
        if want > cards:
            raise RuntimeError(f"deployment {spec['name']!r} asks for num_gpus={want}; this "
                               f"cluster has {cards:g} cards")


def run(target: Application, *, name: str = DEFAULT_APP_NAME,
        route_prefix: Optional[str] = "/", _blocking_timeout_s: float = 120.0,
        http_port: Optional[int] = None, grpc_port: Optional[int] = None) -> DeploymentHandle:
    """Deploys an application, waits until it is RUNNING, and returns its
    ingress handle."""
    if not isinstance(target, Application):
        raise TypeError("serve.run expects Deployment.bind(...) output")
    specs = target._collect(name, {})
    _seal_specs(specs)
    if http_port is not None or grpc_port is not None:
        controller = start(http_port=http_port, grpc_port=grpc_port)
    else:
        controller = _get_or_create_controller()
    _get(controller.deploy_application.remote(name, specs, route_prefix))
    deadline = time.monotonic() + _blocking_timeout_s
    while True:
        app = _get(controller.get_status.remote(), timeout=30).get(name)
        if app and app["status"] == "RUNNING":
            break
        if app and app["status"] == "DEPLOY_FAILED":
            raise RuntimeError(f"application {name!r} failed to deploy:\n{app['message']}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"application {name!r} did not become RUNNING")
        time.sleep(0.05)
    # This process's routers see every running replica from the first call,
    # without waiting for the long poll's push.
    long_poll.get_subscriber().force_refresh()
    return DeploymentHandle(target.deployment.name, name)


def run_from_config(path_or_schema) -> dict:
    """Deploys the applications of a YAML file, a dict or a
    ``ServeDeploySchema``; returns ``{app name: ingress deployment}``."""
    from ray_tpu_torch.serve import schema as schema_mod

    schema = path_or_schema
    if isinstance(schema, str):
        schema = schema_mod.ServeDeploySchema.from_yaml(schema)
    elif isinstance(schema, dict):
        schema = schema_mod.ServeDeploySchema.from_dict(schema)
    return schema_mod.deploy_from_config(schema)


def get_app_handle(name: str = DEFAULT_APP_NAME) -> DeploymentHandle:
    controller = _get_controller()
    status = _get(controller.get_status.remote(), timeout=30)
    if name not in status:
        raise ValueError(f"no application {name!r}")
    for qualified in _get(controller.get_routes.remote(), timeout=30).values():
        app, dep = qualified.split("_", 1)
        if app == name:
            return DeploymentHandle(dep, name)
    return DeploymentHandle(list(status[name]["deployments"])[-1], name)


def get_deployment_handle(deployment_name: str,
                          app_name: str = DEFAULT_APP_NAME) -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def status() -> dict:
    """``{app: {"status", "deployments": {name: {"target_replicas",
    "running_replicas", "states"}}}}``; {} when serve is not running."""
    try:
        controller = _get_controller()
    except ValueError:
        return {}
    return _get(controller.get_status.remote(), timeout=30)


def delete(name: str) -> None:
    _get(_get_controller().delete_application.remote(name))


def shutdown() -> None:
    """Stops every replica, and kills the proxies and the controller."""
    global _primary_port
    _primary_port = None
    long_poll.reset_subscriber()
    with _proxies_lock:
        proxies = list(_proxies.values())
        _proxies.clear()
    try:
        controller = _get_controller()
    except ValueError:
        controller = None
    if controller is not None:
        try:
            _get(controller.shutdown.remote(), timeout=90)
        except Exception:
            pass  # a controller that died: its replicas die with the cluster
        _kill_quietly(controller)
    for handle in proxies:
        _kill_quietly(handle)
