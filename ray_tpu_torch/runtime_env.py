"""Public runtime-env spec type.

Role-equivalent of the reference's
python/ray/runtime_env/runtime_env.py :: RuntimeEnv — a validated dict
describing the environment a job/task/actor runs under. Materialization
happens per node in the agent's RuntimeEnvManager
(ray_tpu_torch/_private/runtime_env.py).

Supported fields:

- ``env_vars``: dict of environment variables for the worker process.
- ``working_dir``: directory the worker starts in; a ``.zip`` path is
  extracted into the per-node cache, a plain directory is used in place.
- ``pip``: list of pip requirements (or a local package path); installed
  into an isolated, cached, per-env ``--target`` directory prepended to
  the worker's ``PYTHONPATH``.
- ``py_modules``: list of local module directories / zips staged into the
  cache and put on ``PYTHONPATH``.
- ``config``: reserved for per-env options (timeouts), passed through.
"""

from __future__ import annotations

from ray_tpu_torch._private.runtime_env import validate_runtime_env


class RuntimeEnv(dict):
    """Validated runtime environment spec (a plain dict underneath)."""

    def __init__(
        self,
        *,
        env_vars: dict | None = None,
        working_dir: str | None = None,
        pip: list | str | dict | None = None,
        py_modules: list | None = None,
        config: dict | None = None,
    ):
        spec: dict = {}
        if env_vars is not None:
            spec["env_vars"] = dict(env_vars)
        if working_dir is not None:
            spec["working_dir"] = str(working_dir)
        if pip is not None:
            spec["pip"] = pip
        if py_modules is not None:
            spec["py_modules"] = list(py_modules)
        if config is not None:
            spec["config"] = dict(config)
        super().__init__(validate_runtime_env(spec))
