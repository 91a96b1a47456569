"""Declarative serve config and the YAML deploy.

The port's copy of ray_tpu's ``serve/schema.py``: a YAML file describes
the applications (each an import path and per-deployment overrides) and
the HTTP options (host, port, the number of proxies);
``serve.run_from_config`` applies it. The ``serve deploy`` command-line
verb waits for the runtime's tools (ROADMAP Queue A item 14d).

Example:

    http_options:
      host: 127.0.0.1
      port: 8200
    applications:
      - name: summarizer
        route_prefix: /api
        import_path: my_pkg.app:graph        # module:attr -> Application
        deployments:
          - name: Summarizer
            num_replicas: 2
            max_ongoing_requests: 16
            user_config: {temperature: 0.2}
            autoscaling_config: {min_replicas: 1, max_replicas: 4}
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional


@dataclasses.dataclass
class DeploymentSchema:
    name: str
    num_replicas: Optional[int] = None
    max_ongoing_requests: Optional[int] = None
    user_config: Any = None
    autoscaling_config: Optional[dict] = None
    ray_actor_options: Optional[dict] = None
    # Reliability: the deadline's seed, the probe timeout, the admission
    # queue, the retry and hedge policy, the drain budget.
    request_timeout_s: Optional[float] = None
    health_probe_timeout_s: Optional[float] = None
    max_queued_requests: Optional[int] = None
    retry_policy: Optional[dict] = None
    graceful_shutdown_timeout_s: Optional[float] = None

    def overrides(self) -> dict:
        out: dict = {}
        for field in (
            "num_replicas", "max_ongoing_requests", "user_config",
            "autoscaling_config", "ray_actor_options",
            "request_timeout_s", "health_probe_timeout_s",
            "max_queued_requests", "retry_policy",
            "graceful_shutdown_timeout_s",
        ):
            value = getattr(self, field)
            if value is not None:
                out[field] = value
        return out


@dataclasses.dataclass
class ServeApplicationSchema:
    name: str
    import_path: str
    route_prefix: str = "/"
    runtime_env: Optional[dict] = None
    deployments: list = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, raw: dict) -> "ServeApplicationSchema":
        deployments = [
            DeploymentSchema(**d) for d in raw.get("deployments", [])
        ]
        return cls(
            name=raw["name"],
            import_path=raw["import_path"],
            route_prefix=raw.get("route_prefix", "/"),
            runtime_env=raw.get("runtime_env"),
            deployments=deployments,
        )


@dataclasses.dataclass
class HTTPOptionsSchema:
    host: str = "127.0.0.1"
    port: int = 8000
    # N proxies on consecutive ports, health-checked and restarted by the
    # controller.
    num_proxies: int = 1


@dataclasses.dataclass
class ServeDeploySchema:
    applications: list
    http_options: HTTPOptionsSchema = dataclasses.field(
        default_factory=HTTPOptionsSchema
    )

    @classmethod
    def from_dict(cls, raw: dict) -> "ServeDeploySchema":
        apps = [
            ServeApplicationSchema.from_dict(a)
            for a in raw.get("applications", [])
        ]
        if not apps:
            raise ValueError("config has no applications")
        http = HTTPOptionsSchema(**(raw.get("http_options") or {}))
        return cls(applications=apps, http_options=http)

    @classmethod
    def from_yaml(cls, path: str) -> "ServeDeploySchema":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: expected a mapping at top level")
        return cls.from_dict(raw)


def _import_target(import_path: str):
    """'pkg.module:attr' -> the bound Application."""
    module_name, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:attribute'"
        )
    module = importlib.import_module(module_name)
    target = module
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def build_application(app_schema: ServeApplicationSchema):
    """Imports the bound application and applies its deployments' overrides."""
    from ray_tpu_torch.serve.api import Application

    app = _import_target(app_schema.import_path)
    if callable(app) and not isinstance(app, Application):
        app = app()  # a builder function
    if not isinstance(app, Application):
        raise TypeError(
            f"{app_schema.import_path} resolved to {type(app).__name__}, "
            "expected a bound Application (Deployment.bind(...))"
        )
    overrides = {d.name: d.overrides() for d in app_schema.deployments}
    if overrides:
        app = _apply_overrides(app, overrides)
    return app


def _apply_overrides(app, overrides: dict):
    """The application graph rebuilt with each named deployment's .options()."""
    from ray_tpu_torch.serve.api import Application

    def rebuild(node):
        if isinstance(node, Application):
            deployment = node.deployment
            if deployment.name in overrides:
                deployment = deployment.options(**overrides[deployment.name])
            args = tuple(rebuild(a) for a in node.args)
            kwargs = {k: rebuild(v) for k, v in node.kwargs.items()}
            return Application(deployment, args, kwargs)
        if isinstance(node, (list, tuple)):
            rebuilt = [rebuild(x) for x in node]
            return type(node)(rebuilt)
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        return node

    return rebuild(app)


def deploy_from_config(schema: ServeDeploySchema) -> dict:
    """Applies a deploy schema: starts the proxies, runs every application.
    Returns {app name: ingress deployment name}."""
    from ray_tpu_torch.serve import api

    api.start(
        http_host=schema.http_options.host,
        http_port=schema.http_options.port,
        num_proxies=schema.http_options.num_proxies,
    )
    deployed = {}
    for app_schema in schema.applications:
        app = build_application(app_schema)
        handle = api.run(
            app, name=app_schema.name, route_prefix=app_schema.route_prefix
        )
        deployed[app_schema.name] = handle.deployment_name
    return deployed
