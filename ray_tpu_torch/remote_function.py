"""@ray_tpu_torch.remote functions.

Role-equivalent of python/ray/remote_function.py :: RemoteFunction._remote:
options handling (num_cpus/resources/num_returns/max_retries/runtime_env/
scheduling_strategy) and pickled-function export through the controller KV
function table (the reference exports via GCS KV the same way).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any

from ray_tpu_torch._private import serialization, worker


class RemoteFunction:
    def __init__(self, fn, **default_options):
        self._fn = fn
        self._options = {
            "num_returns": 1,
            "num_cpus": 1,
            "resources": None,
            "max_retries": None,
            "retry_exceptions": False,
            "runtime_env": None,
            "scheduling_strategy": None,
        }
        self._options.update(default_options)
        self._function_id: str | None = None
        self._exported_for: str | None = None  # job id of the exporting cluster
        self._export_lock = threading.Lock()
        # (ctx, template) — static spec fields cached per cluster context
        self._submit_cache: tuple | None = None
        self.__name__ = getattr(fn, "__name__", "remote_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function cannot be called directly; use "
            f"{self.__name__}.remote(...)"
        )

    def options(self, **options) -> "RemoteFunction":
        clone = RemoteFunction(self._fn, **{**self._options, **options})
        clone._function_id = self._function_id
        clone._exported_for = self._exported_for
        return clone

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_export_lock", None)
        state.pop("_submit_cache", None)  # holds a live CoreContext
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._export_lock = threading.Lock()
        self._submit_cache = None
        if "_exported_for" not in self.__dict__:
            self._exported_for = None

    def _ensure_exported(self) -> str:
        # The export is per-CLUSTER: a module-level @remote function
        # outlives ray_tpu_torch.shutdown()/init() cycles (test modules, repeated
        # drivers), and the next cluster's controller KV starts empty. A
        # plain "already exported" boolean made workers' function-table
        # lookups miss forever on the second cluster.
        ctx = worker.get_global_context()
        cluster_key = ctx.job_id
        if self._function_id is not None and self._exported_for == cluster_key:
            return self._function_id
        with self._export_lock:
            if self._function_id is None or self._exported_for != cluster_key:
                raw = serialization.dumps_function(self._fn)
                function_id = "fn-" + hashlib.sha1(raw).hexdigest()[:20]
                ctx.io.run(
                    ctx.controller.call(
                        "kv_put",
                        {
                            "namespace": "funcs",
                            "key": function_id,
                            "value": raw,
                            "overwrite": False,
                        },
                    )
                )
                self._function_id = function_id
                self._exported_for = cluster_key
        return self._function_id

    def remote(self, *args, **kwargs):
        ctx = worker.get_global_context()
        function_id = self._ensure_exported()
        opts = self._options
        cache = self._submit_cache
        if cache is None or cache[0] is not ctx:
            resources = dict(opts["resources"] or {})
            if opts["num_cpus"] is not None:
                resources.setdefault("CPU", opts["num_cpus"])
            num_gpus = opts.get("num_gpus")
            if num_gpus:
                resources["GPU"] = num_gpus
            template = ctx.make_spec_template(
                function_id=function_id,
                name=self.__name__,
                num_returns=opts["num_returns"],
                resources=resources,
                max_retries=opts["max_retries"],
                retry_exceptions=opts["retry_exceptions"],
                runtime_env=opts["runtime_env"],
                scheduling_strategy=opts["scheduling_strategy"],
            )
            self._submit_cache = cache = (ctx, template)
        refs = ctx.submit_task(
            args=args, kwargs=kwargs, spec_template=cache[1],
        )
        return refs[0] if opts["num_returns"] == 1 else refs
