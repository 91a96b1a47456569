"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

The port runs on an NVIDIA Hopper card (H100, ``sm_90a``). Its kernels are
written by hand in CUDA C++ (``ops/csrc/``) and built at first use; each has
a plain PyTorch version beside it that serves CPU tensors only.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
With no card and no explicit ``device="cpu"`` it raises ``RuntimeError``: the
port never runs on the CPU without being asked to.

Tasks, actors and objects (the reference's ``ray_tpu.init/remote/get/put/
wait/kill``) run on the port's own runtime: a controller, a node agent with
its shared-memory store, and worker processes (``_private/``), over the C++
engine built from ``_native/src/``. ``@remote(num_gpus=...)`` leases cards;
a worker sees only its lease's cards through ``CUDA_VISIBLE_DEVICES``, and a
worker with no GPU lease sees none.

Gangs (``util.gang``, in placement groups: ``util.placement_group`` and
``util.scheduling_strategies``), the trainer, Tune's trials, RLlib's
runners and remote learners, and serve all run on the runtime and lease
from the node agent, so each needs ``init()`` first.
``cluster_resources()`` and ``available_resources()`` read the controller
once ``init()`` has run. Before it, they read this host's resource ledger
(``_private.resources``), which only the local task layer of ``data/`` and
``dag/`` (``_private/local_tasks.py``) leases from, until ROADMAP item
14b-ii-b-2 moves that layer onto the runtime.

Importing the package imports no torch and none of the runtime: the names
of the runtime's API load on first use, so a data worker process, which
unpickles the package's functions by name, starts without them.
"""

from __future__ import annotations

import sys

from ray_tpu_torch._private import resources as _resources

__version__ = "0.1.0"

# Public name -> the module that defines it, loaded on first use.
_LAZY = {
    "ObjectRef": "ray_tpu_torch._private.object_ref",
    "init": "ray_tpu_torch._private.worker",
    "shutdown": "ray_tpu_torch._private.worker",
    "is_initialized": "ray_tpu_torch._private.worker",
    "get": "ray_tpu_torch._private.worker",
    "put": "ray_tpu_torch._private.worker",
    "wait": "ray_tpu_torch._private.worker",
    "cancel": "ray_tpu_torch._private.worker",
    "kill": "ray_tpu_torch._private.worker",
    "nodes": "ray_tpu_torch._private.worker",
    "timeline": "ray_tpu_torch._private.worker",
    "get_actor": "ray_tpu_torch.actor",
    "ActorClass": "ray_tpu_torch.actor",
    "ActorHandle": "ray_tpu_torch.actor",
    "RemoteFunction": "ray_tpu_torch.remote_function",
}

_DEFAULT_OPTION_KEYS = {
    "num_cpus", "num_gpus", "num_returns", "resources", "max_retries",
    "retry_exceptions", "runtime_env", "scheduling_strategy", "name",
    "namespace", "lifetime", "max_restarts", "max_task_retries",
    "max_concurrency", "memory",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        if name == "exceptions":
            import ray_tpu_torch.exceptions as exceptions

            return exceptions
        raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def _runtime_up() -> bool:
    worker = sys.modules.get("ray_tpu_torch._private.worker")
    return worker is not None and worker.is_initialized()


def cluster_resources() -> dict:
    """The controller's totals once ``init()`` has run; before it, this
    host's ledger (``_private.resources``), the local task layer's, until
    ROADMAP item 14b-ii-b-2 retires it."""
    if _runtime_up():
        return sys.modules["ray_tpu_torch._private.worker"].cluster_resources()
    return _resources.cluster_resources()


def available_resources() -> dict:
    """What the controller has free once ``init()`` has run; before it,
    this host's ledger, as ``cluster_resources``."""
    if _runtime_up():
        return sys.modules["ray_tpu_torch._private.worker"].available_resources()
    return _resources.available_resources()


def remote(*args, **options):
    """@ray_tpu_torch.remote — turn a function into a task or a class into an actor.

    Usage (same shapes as the reference's @ray.remote, with ``num_gpus``
    where it has ``num_tpus``):
        @ray_tpu_torch.remote
        def f(x): ...

        @ray_tpu_torch.remote(num_cpus=2, num_gpus=1)
        class A: ...
    """
    from ray_tpu_torch.actor import ActorClass
    from ray_tpu_torch.remote_function import RemoteFunction

    if len(args) == 1 and not options and (callable(args[0]) or isinstance(args[0], type)):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only")
    bad = set(options) - _DEFAULT_OPTION_KEYS
    if bad:
        raise TypeError(f"unknown @remote options: {sorted(bad)}")

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, **{
                k: v for k, v in options.items()
                if k not in ("num_returns", "max_retries", "retry_exceptions", "memory")
            })
        return RemoteFunction(target, **{
            k: v for k, v in options.items()
            if k in ("num_returns", "num_cpus", "num_gpus", "resources",
                     "max_retries", "retry_exceptions", "runtime_env",
                     "scheduling_strategy")
        })

    return decorator


def get_runtime_context() -> dict:
    from ray_tpu_torch._private import worker

    ctx = worker.get_global_context()
    return {
        "job_id": ctx.job_id,
        "node_id": ctx.node_id,
        "worker_id": ctx.worker_id,
        "is_driver": ctx.is_driver,
    }


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default; raises when a CUDA device is asked for and absent."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


__all__ = [
    "ObjectRef",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "cancel",
    "kill",
    "nodes",
    "timeline",
    "cluster_resources",
    "available_resources",
    "get_actor",
    "get_runtime_context",
    "ActorClass",
    "ActorHandle",
    "RemoteFunction",
    "exceptions",
    "resolve_device",
]
