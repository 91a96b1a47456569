"""Collective communication for the port's gangs: NCCL and gloo over
``torch.distributed``, the host-memory ``ring`` with its block-scaled
int8/fp8 wire, the bucketed overlap, and the comm flight recorder.

The package keeps the names callers imported from the single module it
replaced (``from ray_tpu_torch.util import collective``, then
``collective.init_collective_group``, ``collective.get_group``, ...), and
re-exports ``CollectiveConfig``, ``ErrorFeedback`` and ``fp8_supported``
as the reference's package does. The names load on first use, so
``flight`` (stdlib alone) imports without torch: the compiled graphs'
relay actors record into it without loading torch.
"""

import importlib

_NAMES = {
    "collective": (
        "MAX", "MIN", "PRODUCT", "SUM", "HierarchicalGroup", "NcclGroup", "RingGroup",
        "_groups", "allgather", "allreduce", "barrier", "broadcast", "comm_flight",
        "destroy_collective_group", "get_group", "init_collective_group", "recv",
        "reducescatter", "send",
    ),
    "quantization": ("CollectiveConfig", "ErrorFeedback", "fp8_supported"),
}
_WHERE = {name: module for module, names in _NAMES.items() for name in names}


def __getattr__(name: str):
    module = _WHERE.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_WHERE))
