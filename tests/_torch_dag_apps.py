"""Plain actor classes for the compiled-graph parity tests
(``tests/test_torch_dag.py``, ``tests/test_torch_dag_recovery.py``).

Each test wraps them for both packages: ``ray_tpu.remote(cls)`` (the
reference pickles this module by value) and ``local_tasks.remote(cls)``
(the port's actor processes import it by name). The module imports
nothing of either package, so a port actor never loads the JAX package.
"""

import os
import time


class Stage:
    def __init__(self, offset):
        self.offset = offset

    def add(self, x):
        return x + self.offset

    def slow_add(self, x):
        time.sleep(0.3)
        return x + self.offset

    def join(self, a, b):
        return a + b

    def boom(self, x):
        raise RuntimeError("stage exploded")

    def echo(self, x):
        return x

    def env(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


class Accumulator:
    """A stateful stage with the __dag_snapshot__/__dag_restore__ hooks."""

    def __init__(self):
        self.total = 0

    def accum(self, x):
        self.total += x
        return self.total

    def __dag_snapshot__(self):
        return {"total": self.total}

    def __dag_restore__(self, state):
        self.total = state["total"]


def visible_devices(_):
    """A data worker's (pool task's) ``CUDA_VISIBLE_DEVICES``."""
    return os.environ.get("CUDA_VISIBLE_DEVICES")


class ExitOnMarker:
    """An actor whose constructor ends its process (exit code 3) once the
    marker file exists: each restart after the marker dies before it
    answers."""

    def __init__(self, marker):
        if os.path.exists(marker):
            os._exit(3)
        self.marker = marker

    def pid(self):
        return os.getpid()
