"""The port's gang (``ray_tpu_torch.util.gang.WorkerGang``), with the
reference's meaning (``ray_tpu/util/gang.py``): one runtime actor a rank in
a placement group, each in the process group and the collective group on
the CPU (gloo); ``run`` SPMD-executes a function on every member; a
member's exception raises ``WorkerError``, a member's death
``GangDiedError``; ``shutdown`` kills every member and removes the group;
a rendezvous port taken before rank 0 binds it starts the gang again on
another. The module boots one cluster (``ray_tpu_torch.init``) that
declares a card this host does not have, so that a GPU bundle places.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import exceptions
from ray_tpu_torch.util import placement_group as pgs
from ray_tpu_torch.util.gang import GangDiedError, WorkerError, WorkerGang


def _identity(ctx, x=0, *, y=0):
    total = ctx.collective().allreduce(np.array([ctx.rank + 1.0]))
    return {"rank": ctx.rank, "world": ctx.world_size, "x": x, "y": y, "pid": os.getpid(),
            "sum": float(total[0]), "device": str(ctx.device)}


def _remember(ctx, value):
    ctx.state["value"] = value
    return True


def _recall(ctx):
    return ctx.state.get("value")


def _raise(ctx):
    raise KeyError(f"rank {ctx.rank}")


def _die(ctx, rank):
    if ctx.rank == rank:
        os._exit(3)
    return "survived"


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _gone(pids, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    return not any(_alive(p) for p in pids)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=6, num_gpus=1)
    yield
    rt.shutdown()


@pytest.fixture(scope="module")
def gang(cluster):
    gang = WorkerGang(2, use_gpu=False)
    yield gang
    gang.shutdown()


def test_gang_runs_every_member_in_one_group(gang):
    results = gang.run(_identity, per_rank_args=[(10,), (11,)], y=5)
    assert [r["rank"] for r in results] == [0, 1]
    assert [r["x"] for r in results] == [10, 11] and all(r["y"] == 5 for r in results)
    assert all(r["world"] == 2 and r["sum"] == 3.0 and r["device"] == "cpu" for r in results)
    infos = gang.rank_infos()
    assert [i["rank"] for i in infos] == [0, 1]
    assert [i["pid"] for i in infos] == [r["pid"] for r in results] and infos[0]["pid"] != \
        infos[1]["pid"]
    assert gang.healthy()
    # State persists across run() calls on the same member.
    assert gang.run(_remember, per_rank_args=[("a",), ("b",)]) == [True, True]
    assert gang.run(_recall) == ["a", "b"]
    with pytest.raises(ValueError, match="per_rank_args"):
        gang.run(_identity, per_rank_args=[(1,)])


def test_member_exception_raises_worker_error(gang):
    with pytest.raises(WorkerError, match="KeyError") as err:
        gang.run(_raise)
    assert err.value.rank == 0 and "Traceback" in err.value.worker_traceback
    # The members live on and run the next call.
    assert gang.healthy()
    assert gang.run(_recall) == ["a", "b"]


def test_member_death_raises_gang_died_and_shutdown_reaps(cluster):
    free = rt.available_resources()
    gang = WorkerGang(2, use_gpu=False)
    pids = [i["pid"] for i in gang.rank_infos()]
    try:
        # The runtime names the exit code in the error only when its record
        # of the death came before the failed call's answer; rank 1's
        # process is gone either way.
        with pytest.raises(GangDiedError, match=r"rank=1 died"):
            gang.run(_die, per_rank_args=[(1,), (1,)], timeout=120)
        assert not gang.healthy() and gang.died() == [1]
    finally:
        gang.shutdown()
    assert _gone(pids)
    # The group is gone and its bundles are back.
    assert all(pg["state"] == "REMOVED" for pg in pgs.placement_group_table()
               if pg["pg_id"] == gang.pg.id)
    deadline = time.monotonic() + 10
    while rt.available_resources() != free and time.monotonic() < deadline:
        time.sleep(0.05)
    assert rt.available_resources() == free


def test_more_gpus_than_the_host_has_are_refused(cluster):
    """The cluster holds one card: a gang of two whole-card members does not
    place within its timeout, and leaves no group behind."""
    with pytest.raises(exceptions.PlacementGroupUnschedulableError):
        WorkerGang(2, use_gpu=True, ready_timeout=1.0)
    assert all(pg["state"] == "REMOVED" for pg in pgs.placement_group_table()
               if "GPU" in pg["bundles"][0])


def test_a_taken_rendezvous_port_starts_the_gang_again(cluster, monkeypatch):
    """The port probed free is taken before rank 0's store binds it (here
    by a listening socket of the test): the gang starts again on another
    port and forms."""
    from ray_tpu_torch.util import gang as gang_mod

    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    ports = [taken.getsockname()[1]]
    real = gang_mod._free_port
    monkeypatch.setattr(gang_mod, "_free_port",
                        lambda: ports.pop() if ports else real())
    try:
        gang = WorkerGang(2, use_gpu=False)
    finally:
        taken.close()
    pids = [i["pid"] for i in gang.rank_infos()]
    try:
        assert not ports
        assert [r["sum"] for r in gang.run(_identity, timeout=120)] == [3.0, 3.0]
    finally:
        gang.shutdown()
    assert _gone(pids)
