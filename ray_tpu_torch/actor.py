"""@ray_tpu_torch.remote actor classes.

Role-equivalent of python/ray/actor.py :: ActorClass / ActorHandle /
ActorMethod — remote class instantiation, .options() (name/lifetime/
max_restarts/max_task_retries/max_concurrency/resources/scheduling
strategy), named + detached actors, handle serialization.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import serialization, worker
from ray_tpu_torch._private.ids import ActorID


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs, num_returns=1)

    def options(self, *, num_returns: int = 1):
        method = self

        class _Bound:
            def remote(_self, *args, **kwargs):
                return method._handle._invoke(
                    method._name, args, kwargs, num_returns=num_returns
                )

        return _Bound()


class ActorHandle:
    def __init__(self, actor_id: str, methods: list[str], max_task_retries: int = 0):
        self._actor_id = actor_id
        self._methods = set(methods)
        self._max_task_retries = max_task_retries

    def _invoke(self, method: str, args, kwargs, num_returns: int = 1):
        ctx = worker.get_global_context()
        refs = ctx.submit_actor_task(
            self._actor_id,
            method,
            args,
            kwargs,
            num_returns=num_returns,
            max_task_retries=self._max_task_retries,
        )
        return refs[0] if num_returns == 1 else refs

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._methods:
            raise AttributeError(
                f"actor {self._actor_id} has no remote method {name!r}"
            )
        return ActorMethod(self, name)

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, sorted(self._methods), self._max_task_retries),
        )

    def __repr__(self):
        return f"ActorHandle({self._actor_id})"


class ActorClass:
    def __init__(self, cls: type, **default_options):
        self._cls = cls
        self._options = {
            "num_cpus": 1,
            "resources": None,
            "name": None,
            "namespace": None,
            "lifetime": None,
            "max_restarts": 0,
            "max_task_retries": 0,
            "max_concurrency": 1,
            "runtime_env": None,
            "scheduling_strategy": None,
        }
        self._options.update(default_options)
        self._class_id: str | None = None
        self._exported_for: str | None = None  # job id of the exporting cluster
        self._export_lock = threading.Lock()
        self.__name__ = cls.__name__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class cannot be instantiated directly; use "
            f"{self.__name__}.remote(...)"
        )

    def options(self, **options) -> "ActorClass":
        clone = ActorClass(self._cls, **{**self._options, **options})
        clone._class_id = self._class_id
        clone._exported_for = self._exported_for
        return clone

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_export_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._export_lock = threading.Lock()
        if "_exported_for" not in self.__dict__:
            self._exported_for = None

    def _ensure_exported(self) -> str:
        # Per-cluster export (see RemoteFunction._ensure_exported): a
        # module-level actor class outlives shutdown()/init() cycles and
        # must re-export into each new cluster's empty function table.
        ctx = worker.get_global_context()
        cluster_key = ctx.job_id
        if self._class_id is not None and self._exported_for == cluster_key:
            return self._class_id
        with self._export_lock:
            if self._class_id is None or self._exported_for != cluster_key:
                raw = serialization.dumps_function(self._cls)
                class_id = "cls-" + hashlib.sha1(raw).hexdigest()[:20]
                ctx.io.run(
                    ctx.controller.call(
                        "kv_put",
                        {
                            "namespace": "funcs",
                            "key": class_id,
                            "value": raw,
                            "overwrite": False,
                            # Content-addressed, so the token needs no
                            # randomness: any retry of this export is the
                            # same logical write.
                            "mutation_token": f"export:{class_id}",
                        },
                    )
                )
                self._class_id = class_id
                self._exported_for = cluster_key
        return self._class_id

    def _public_methods(self) -> list[str]:
        return [
            name
            for name in dir(self._cls)
            if not name.startswith("_") and callable(getattr(self._cls, name))
        ]

    def remote(self, *args, **kwargs) -> ActorHandle:
        ctx = worker.get_global_context()
        class_id = self._ensure_exported()
        opts = self._options
        resources = dict(opts["resources"] or {})
        resources.setdefault("CPU", opts["num_cpus"])
        num_gpus = opts.get("num_gpus")
        if num_gpus:
            resources["GPU"] = num_gpus
        actor_id = ActorID.random()
        creation_args, _ = serialization.serialize((args, kwargs))
        from ray_tpu_torch._private.core_context import _encode_strategy

        spec = {
            "actor_id": actor_id,
            "class_id": class_id,
            "class_name": self.__name__,
            "methods": self._public_methods(),
            "resources": resources,
            "name": opts["name"],
            "namespace": opts["namespace"] or "default",
            "lifetime": opts["lifetime"],
            "max_restarts": opts["max_restarts"],
            "max_task_retries": opts["max_task_retries"],
            "max_concurrency": opts["max_concurrency"],
            "runtime_env": opts["runtime_env"] or {},
            "scheduling_strategy": _encode_strategy(opts["scheduling_strategy"]),
            "job_id": ctx.job_id,
            "submitter_node": ctx.node_id,
            "creation_args": creation_args,
            # Idempotency token: the client-random actor_id uniquely
            # identifies this logical create, so a transport-level retry
            # after a dropped/duplicated reply is applied exactly once.
            "mutation_token": f"create-actor:{actor_id}",
        }
        resp = ctx.io.run(ctx.controller.call("create_actor", spec))
        if resp["status"] == "name_exists":
            raise ValueError(
                f"actor name {opts['name']!r} is already taken"
            )
        return ActorHandle(actor_id, self._public_methods(), opts["max_task_retries"])


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    """Look up a named actor (reference: ray.get_actor)."""
    ctx = worker.get_global_context()
    resp = ctx.io.run(
        ctx.controller.call(
            "get_named_actor", {"name": name, "namespace": namespace}
        )
    )
    if resp["status"] != "ok":
        raise ValueError(f"no actor named {name!r} in namespace {namespace!r}")
    meta = resp["spec_meta"]
    return ActorHandle(
        resp["actor_id"], meta["methods"], meta.get("max_task_retries", 0)
    )
