"""Helpers for the port's tests that run gangs, trials and RLlib's actors on
the runtime: a module-scoped cluster, and what a test reads of it after a
run (the actors and placement groups left, the free resources, the
processes gone)."""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import worker
from ray_tpu_torch.util import placement_group as pgs


def cluster_fixture(autouse: bool = False, **init_kwargs):
    """A module-scoped fixture that boots one cluster with ``init_kwargs``
    and shuts it down after the module."""

    @pytest.fixture(scope="module", autouse=autouse)
    def cluster():
        rt.init(**init_kwargs)
        yield
        rt.shutdown()

    return cluster


def actors(class_name: str | None = None) -> list[dict]:
    """The controller's actor records (``class_name``, ``state``, ``pid``)."""
    ctx = worker.get_global_context()
    found = ctx.io.run(ctx.controller.call("list_actors", {}))
    return [a for a in found if class_name is None or a.get("class_name") == class_name]


def live_groups() -> list[dict]:
    """Placement groups not removed."""
    return [pg for pg in pgs.placement_group_table() if pg["state"] != "REMOVED"]


def alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


def gone(pids, timeout: float = 10.0) -> bool:
    """Whether every process of ``pids`` has ended within ``timeout``."""
    deadline = time.monotonic() + timeout
    while any(alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    return not any(alive(p) for p in pids)


def settled(free: dict, timeout: float = 10.0) -> bool:
    """Whether the cluster's free resources come back to ``free`` and no
    placement group is left within ``timeout``."""
    deadline = time.monotonic() + timeout
    while (rt.available_resources() != free or live_groups()) and time.monotonic() < deadline:
        time.sleep(0.05)
    return rt.available_resources() == free and not live_groups()


def all_dead(class_names=("_TrialActor", "_GangMember"), timeout: float = 10.0) -> bool:
    """Whether every actor of ``class_names`` is recorded dead within
    ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        live = [a for a in actors() if a.get("class_name") in class_names
                and a["state"] != "DEAD"]
        if not live or time.monotonic() > deadline:
            return not live
        time.sleep(0.05)
