"""The public serve API: ``@serve.deployment``, ``.bind()``, ``serve.run``.

Port of ray_tpu's ``serve/api.py``. ``Deployment.bind(...)`` builds an
application graph (bound sub-deployments become handles when the replica
is built); ``serve.run`` hands the graph to the controller, which lives in
this process, waits until every deployment has its replicas running, and
returns the ingress handle. ``serve.start`` starts the controller, the
HTTP proxy (on this process's I/O loop), ``num_proxies - 1`` more HTTP
proxies on the next ports, each a process of its own that the controller
health-checks and restarts under its name and port, and with
``grpc_port`` the gRPC proxy. ``serve.run_from_config`` deploys the
applications a YAML file (or its dict) describes (``schema``). One serve
instance per process, as the reference keeps one per cluster.

A deployment's class or function must be importable from a module (its
replicas are processes that import it by name: the port depends on no
cloudpickle), and so must every argument it is bound with pickle.
``ray_actor_options={"num_gpus": g}`` places each replica on the cards
(a lease of this process's resource ledger, ``_private.resources``);
``num_tpus`` and ``resources`` lease their keys from the same ledger, and
a replica asking for a key the host never declared waits as PENDING.
``serve.run`` refuses a deployment that asks for more cards than the host
has, and one that asks for a card on a host with none. ``num_cpus`` is
accepted and reserves nothing: one host runs every replica.
``kv_headroom_min`` raises ``NotImplementedError`` naming ROADMAP Queue A
item 13, the serve-LLM engine that would feed it.
"""

from __future__ import annotations

import atexit
import copy
import pickle
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.serve import long_poll
from ray_tpu_torch.serve._common import (
    DEFAULT_APP_NAME, SERVE_LLM_ITEM, AutoscalingConfig, DeploymentConfig, RetryPolicy,
)
from ray_tpu_torch.serve.handle import DeploymentHandle, _HandlePlaceholder


class _Serve:
    """This process's serve instance: the controller and the proxy."""

    def __init__(self):
        self.lock = threading.Lock()
        self.controller = None
        self.proxy = None
        self.grpc_proxy = None


_instance = _Serve()


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
        specs.append({
            "name": self.deployment.name, "cls_or_fn": self.deployment.func_or_class,
            "init_args": init_args, "init_kwargs": init_kwargs,
            "config": self.deployment._config, "route_prefix": self.deployment._route_prefix,
        })
        return specs


# The replica options the controller reads, as the reference's does.
ACTOR_OPTIONS = frozenset({"num_gpus", "num_cpus", "num_tpus", "resources"})


def _check_config(config: DeploymentConfig) -> DeploymentConfig:
    """Refuses what no replica could be given."""
    asc = config.autoscaling_config
    if asc is not None and asc.kv_headroom_min is not None:
        raise NotImplementedError(
            f"autoscaling on KV headroom waits for the serve-LLM engine ({SERVE_LLM_ITEM})")
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
# the serve instance
# ---------------------------------------------------------------------------
def _controller():
    from ray_tpu_torch.serve.controller import ServeController

    with _instance.lock:
        if _instance.controller is None:
            _instance.controller = ServeController()
            long_poll.set_controller(_instance.controller)
        return _instance.controller


def _running_controller():
    if _instance.controller is None:
        raise RuntimeError("serve is not running: call serve.start() or serve.run()")
    return _instance.controller


def start(http_host: str = "127.0.0.1", http_port: Optional[int] = 8000,
          grpc_port: Optional[int] = None, num_proxies: int = 1):
    """Starts the controller and an HTTP proxy on ``http_port`` (None: no
    HTTP proxy change), and ``num_proxies - 1`` more on the ports after it,
    each a process the controller restarts if it dies; clients fail over
    between them. ``grpc_port`` starts the gRPC proxy. A new port replaces
    the proxy on the old one. Every proxy is registered with the
    controller, which scrapes their route latencies for the autoscaler."""
    controller = _controller()
    if http_port is not None:
        from ray_tpu_torch.serve.proxy import HTTPProxy

        with _instance.lock:
            proxy = _instance.proxy
            if proxy is None or (proxy.host, proxy.port) != (http_host, http_port):
                if proxy is not None:
                    controller.unregister_proxy(_proxy_name("http", proxy.port))
                    proxy.shutdown()
                proxy = _instance.proxy = HTTPProxy(http_host, http_port)
                controller.register_proxy(_proxy_name("http", http_port), "http", http_host,
                                          http_port, local=proxy)
        registered = {p["name"] for p in controller.get_proxies()}
        for port in range(http_port + 1, http_port + num_proxies):
            if _proxy_name("http", port) not in registered:
                controller.register_proxy(_proxy_name("http", port), "http", http_host, port)
    if grpc_port is not None:
        from ray_tpu_torch.serve.grpc_proxy import GRPCProxy

        with _instance.lock:
            proxy = _instance.grpc_proxy
            if proxy is None or proxy.port != grpc_port:
                if proxy is not None:
                    controller.unregister_proxy(_proxy_name("grpc", proxy.port))
                    proxy.shutdown()
                proxy = _instance.grpc_proxy = GRPCProxy(http_host, grpc_port)
                controller.register_proxy(_proxy_name("grpc", grpc_port), "grpc", http_host,
                                          grpc_port, local=proxy)
    return controller


def _proxy_name(protocol: str, port: int) -> str:
    """A proxy's name, the reference's."""
    return f"SERVE_{'GRPC_' if protocol == 'grpc' else ''}PROXY::{port}"


def _check_specs(specs: list[dict]) -> None:
    """Refuses, before anything starts, a deployment its replicas could not
    import or be given (a class defined in a function, arguments that do
    not pickle), and one asking for more cards than the host has."""
    from ray_tpu_torch._private import resources
    from ray_tpu_torch.serve.replica import CallableRef

    cards = int(resources.cluster_resources()["GPU"])
    for spec in specs:
        CallableRef(spec["cls_or_fn"])
        try:
            pickle.dumps((spec["init_args"], spec["init_kwargs"], spec["config"].user_config))
        except (pickle.PicklingError, TypeError, AttributeError) as exc:
            raise TypeError(f"deployment {spec['name']!r}: its arguments must pickle, since "
                            f"each replica is a process: {exc}") from exc
        want = float(spec["config"].ray_actor_options.get("num_gpus", 0) or 0)
        if want > 0 and cards == 0:
            raise RuntimeError(
                f"deployment {spec['name']!r} asks for num_gpus={want} and this host has no "
                f"CUDA device; a replica without a card sets num_gpus=0")
        if want > cards:
            raise RuntimeError(f"deployment {spec['name']!r} asks for num_gpus={want}; this "
                               f"host has {cards} cards")


def run(target: Application, *, name: str = DEFAULT_APP_NAME,
        route_prefix: Optional[str] = "/", _blocking_timeout_s: float = 120.0,
        http_port: Optional[int] = None, grpc_port: Optional[int] = None) -> DeploymentHandle:
    """Deploys an application, waits until it is RUNNING, and returns its
    ingress handle."""
    if not isinstance(target, Application):
        raise TypeError("serve.run expects Deployment.bind(...) output")
    specs = target._collect(name, {})
    _check_specs(specs)
    if http_port is not None or grpc_port is not None:
        start(http_port=http_port, grpc_port=grpc_port)
    controller = _controller()
    controller.deploy_application(name, specs, route_prefix)
    deadline = time.monotonic() + _blocking_timeout_s
    while True:
        app = controller.get_status().get(name)
        if app and app["status"] == "RUNNING":
            break
        if app and app["status"] == "DEPLOY_FAILED":
            raise RuntimeError(f"application {name!r} failed to deploy:\n{app['message']}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"application {name!r} did not become RUNNING")
        time.sleep(0.05)
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
    controller = _running_controller()
    status = controller.get_status()
    if name not in status:
        raise ValueError(f"no application {name!r}")
    for qualified in controller.get_routes().values():
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
    if _instance.controller is None:
        return {}
    return _instance.controller.get_status()


def delete(name: str) -> None:
    _running_controller().delete_application(name)


def shutdown() -> None:
    """Stops the proxies, every replica and the controller."""
    with _instance.lock:
        controller, proxies = _instance.controller, (_instance.proxy, _instance.grpc_proxy)
        _instance.controller = _instance.proxy = _instance.grpc_proxy = None
    for proxy in proxies:
        if proxy is not None:
            proxy.shutdown()
    if controller is not None:
        long_poll.set_controller(None)
        controller.shutdown()


# Replicas are processes of this one; stop them before multiprocessing
# joins its children at exit.
atexit.register(shutdown)
