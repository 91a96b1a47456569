"""The port's gang (``ray_tpu_torch.util.gang.WorkerGang``), with the
reference's meaning (``ray_tpu/util/gang.py``): one spawned process a
rank, each in the process group and the collective group on the CPU
(gloo); ``run`` SPMD-executes a function on every member; a member's
exception raises ``WorkerError``, a member's death ``GangDiedError``; and
``shutdown`` reaps every process; a rendezvous port taken before rank 0
binds it starts the gang again on another.
"""

import os
import socket

import numpy as np
import pytest
import torch

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


@pytest.fixture(scope="module")
def gang():
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
    # rank 1's error is still in its pipe; the members live on.
    kind, *_ = gang.recv(1, timeout=60)
    assert kind == "error" and gang.healthy()


def test_member_death_raises_gang_died_and_shutdown_reaps():
    gang = WorkerGang(2, use_gpu=False)
    try:
        with pytest.raises(GangDiedError, match="rank=1 exit code 3"):
            gang.run(_die, per_rank_args=[(1,), (1,)], timeout=120)
        assert not gang.healthy() and gang.died() == [1]
    finally:
        gang.shutdown()
    assert all(not p.is_alive() for p in gang.members)
    assert [p.exitcode for p in gang.members] == [0, 3]


def test_more_gpus_than_the_host_has_are_refused():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    with pytest.raises(ValueError, match="asks for 2 GPUs"):
        WorkerGang(2, use_gpu=True)


def test_a_taken_rendezvous_port_starts_the_gang_again(monkeypatch):
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
    try:
        assert not ports
        assert [r["sum"] for r in gang.run(_identity, timeout=120)] == [3.0, 3.0]
    finally:
        gang.shutdown()
    assert all(not p.is_alive() for p in gang.members)
