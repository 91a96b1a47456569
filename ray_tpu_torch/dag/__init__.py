"""Compiled graphs (ray_tpu's ``dag/``) on the port's local actors.

Build a graph with ``InputNode`` and ``handle.method.bind(...)`` on actors
of ``ray_tpu_torch._private.local_tasks``, then ``experimental_compile()``
it (``channel="shm"``, ``"device"`` or ``"socket"``; ``supervise=True``
for exactly-once recovery). See ``dag/dag.py``.
"""

from ray_tpu_torch.dag.dag import (
    ActorDiedError,
    ClassMethodNode,
    CompiledDAG,
    DAGActorDiedError,
    DAGNode,
    DAGRef,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "InputNode",
    "DAGNode",
    "ClassMethodNode",
    "CompiledDAG",
    "DAGRef",
    "MultiOutputNode",
    "ActorDiedError",
    "DAGActorDiedError",
]
