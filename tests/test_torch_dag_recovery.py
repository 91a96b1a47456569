"""Exactly-once recovery of the port's compiled graphs, on the CPU.

A supervised graph (``experimental_compile(supervise=True)``) survives the
death of an actor with executions in flight: the supervisor restarts the
victim (``local_tasks.restart_actor``), re-opens every channel under a new
epoch and replays the retained inputs, and the caller's stream completes
exactly once. An unsupervised graph raises a typed ``DAGActorDiedError``
naming the actor, its rank and the edge, and frees everything itself. A
frame left from before a recovery is discarded and counted.

The reference's own recovery tests are unsteady (ROADMAP Queue C item 4),
so these hold the port to the expected values, not to a reference run.
"""

import time

import pytest

import _torch_dag_apps as apps
from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.dag import DAGActorDiedError, InputNode
from ray_tpu_torch.dag import channel as shm

Stage = local_tasks.remote(apps.Stage)
Accumulator = local_tasks.remote(apps.Accumulator)


@pytest.fixture(scope="module", autouse=True)
def port_runtime():
    yield
    local_tasks.shutdown()


@pytest.mark.parametrize("family", ["shm", "device"])
def test_supervised_dag_survives_kill_exactly_once(family):
    """Kill the middle of three actors with a window in flight: every
    in-flight seq arrives once, the recovery names the victim and its rank,
    and the recovered graph is back to a steady state without messages."""
    a, b, c = Stage.remote(1), Stage.remote(1), Stage.remote(1)
    with InputNode() as inp:
        out = c.add.bind(b.add.bind(a.add.bind(inp)))
    dag = out.experimental_compile(channel=family, supervise=True)
    victim_rank = dag._plan.rank_of(b._actor_id)
    try:
        assert [dag.execute(i).get(timeout=60) for i in range(3)] == [3, 4, 5]
        refs = [dag.execute(i) for i in range(3, 7)]
        local_tasks.kill(b)
        time.sleep(0.3)
        assert [r.get(timeout=120) for r in refs] == [6, 7, 8, 9]
        assert dag.recoveries == 1 and dag._epoch == 1
        rec = dag.last_recovery
        assert rec["victims"] == [b._actor_id] and rec["victim_ranks"] == [victim_rank]
        assert rec["epoch"] == 1 and rec["duration_s"] > 0
        assert local_tasks.actor_info(b._actor_id)["state"] == "ALIVE"
        assert sum(len(r._ready) for r in dag._out_readers) == 0  # no duplicate parked
        before = local_tasks.actor_messages()
        assert [dag.execute(i).get(timeout=60) for i in range(5)] == [3, 4, 5, 6, 7]
        assert local_tasks.actor_messages() == before
    finally:
        dag.close(timeout=5.0)


def test_stateful_actor_resumes_from_snapshot():
    """A killed stateful actor comes back at its last __dag_snapshot__: the
    retained seq after the commit replays into a result the reader drops,
    and the next seq lands on the restored state (a restart from scratch
    would give 2)."""
    acc = Accumulator.remote()
    with InputNode() as inp:
        out = acc.accum.bind(inp)
    dag = out.experimental_compile(supervise=True)
    try:
        assert [dag.execute(1).get(timeout=60) for _ in range(4)] == [1, 2, 3, 4]
        assert dag.snapshot() == 4  # commit at total 4
        assert dag.execute(1).get(timeout=60) == 5
        local_tasks.kill(acc)
        time.sleep(0.3)
        assert dag.execute(1).get(timeout=120) == 6
        assert dag.recoveries == 1
        assert dag.replay_discards == 1
        assert dag.execute(1).get(timeout=60) == 7
    finally:
        dag.close(timeout=5.0)


def test_unsupervised_death_raises_with_its_edge_and_cleans_up():
    """The typed error names the actor, its rank and the edge it was seen
    on; the failure path frees every slot and refuses new work, without a
    close()."""
    a, b = Stage.remote(1), Stage.remote(2)
    with InputNode() as inp:
        out = b.add.bind(a.add.bind(inp))
    dag = out.experimental_compile()
    dag_id = dag.dag_id
    assert dag.execute(0).get(timeout=60) == 3
    local_tasks.kill(b)
    time.sleep(0.3)
    ref = dag.execute(1)
    with pytest.raises(DAGActorDiedError) as excinfo:
        ref.get(timeout=6.0)
    err = excinfo.value
    assert (err.actor_id, err.rank, err.family, err.epoch, err.seq) == (
        b._actor_id, 2, "shm", 0, 1)
    assert err.channel == f"dagch-{dag_id}-out-0"
    assert b._actor_id in str(err) and "dag rank 2" in str(err)
    assert dag._torn_down
    assert [n for n in shm.local_store().list() if n.startswith(f"dagch-{dag_id}")] == []
    with pytest.raises(RuntimeError, match="torn down"):
        dag.execute(9)
    dag.close()  # a no-op after the failure's teardown


def test_death_error_pickles_as_the_reference():
    """The copied error type keeps the reference's ``__reduce__``: the edge
    evidence survives the wire as attributes, the message as the
    constructor's arguments rebuild it."""
    import pickle

    from ray_tpu import exceptions as ref_exceptions

    args = ("dag-1", "actor-1", 3, "gone")
    edge = dict(channel="dagch:p0:e1:2:0", family="device", epoch=2, seq=7)
    port, ref = DAGActorDiedError(*args, **edge), ref_exceptions.DAGActorDiedError(*args, **edge)
    assert str(port) == str(ref)
    port_back, ref_back = pickle.loads(pickle.dumps(port)), pickle.loads(pickle.dumps(ref))
    fields = ("dag_id", "actor_id", "rank", "detail", "channel", "family", "epoch", "seq")
    assert [getattr(port_back, f) for f in fields] == [getattr(ref_back, f) for f in fields] \
        == [*args, *edge.values()]
    assert str(port_back) == str(ref_back)


def test_epoch_fencing_discards_stale_frame():
    """A pre-recovery (old-epoch) frame in a re-opened ring is discarded and
    counted, freeing the slot for the replaying producer; a frame AHEAD of
    the consumer's epoch is an error."""
    store = shm.local_store()
    name = "fence-test-slot-0"
    parts, total = shm.serialize_parts({"v": 1})
    assert shm.try_write_seq(store, name, 7, parts, total, epoch=0)
    assert not shm.try_write_seq(store, name, 7, parts, total, epoch=0)  # occupied
    before = shm.stale_frame_count()
    assert shm.read_seq_consume(store, name, 7, epoch=1) is shm.NOT_READY
    assert shm.stale_frame_count() == before + 1
    parts2, total2 = shm.serialize_parts({"v": 2})
    assert shm.try_write_seq(store, name, 7, parts2, total2, epoch=1)
    assert shm.read_seq_consume(store, name, 7, epoch=1) == {"v": 2}
    assert shm.try_write_seq(store, name, 8, parts, total, epoch=2)
    with pytest.raises(RuntimeError, match="ahead"):
        shm.read_seq_consume(store, name, 8, epoch=1)
    shm._free_slot(store, name)


def test_slot_store_api():
    """create raises on an occupied slot; seal publishes; get times out to
    None; a zero-copy value is read-only and frees its slot when it dies."""
    import gc

    import numpy as np

    store = shm.local_store()
    view = store.create("api-slot", 3)
    view[:] = b"abc"
    store.seal("api-slot")
    with pytest.raises(FileExistsError):
        store.create("api-slot", 3)
    assert bytes(store.get("api-slot")) == b"abc"
    store.delete("api-slot")
    assert store.get("api-slot", timeout_ms=20) is None
    parts, total = shm.serialize_parts(np.arange(shm.ZERO_COPY_THRESHOLD, dtype=np.uint8))
    assert shm.try_write(store, "big-slot", parts, total)
    value = shm.read_consume(store, "big-slot")
    assert not value.flags.writeable and "big-slot" in store.list()
    del value
    gc.collect()
    assert "big-slot" not in store.list()


def test_restart_actor_keeps_the_id_and_the_constructor():
    """The controller's restart_actor: a dead actor comes back under its id
    from the same constructor arguments; max_restarts restarts an actor
    that died without being asked to."""
    a = Stage.remote(5)
    assert local_tasks.get(a.add.remote(1), timeout=60) == 6
    local_tasks.kill(a)
    assert local_tasks.actor_info(a._actor_id)["state"] == "DEAD"
    with pytest.raises(local_tasks.WorkerCrashedError):
        local_tasks.get(a.add.remote(1), timeout=60)
    assert local_tasks.restart_actor(a._actor_id)["state"] == "RESTARTING"
    assert local_tasks.actor_info(a._actor_id, wait_ready=True)["state"] == "ALIVE"
    assert local_tasks.get(a.add.remote(1), timeout=60) == 6
    b = Stage.options(max_restarts=1).remote(7)
    info = local_tasks.actor_info(b._actor_id, wait_ready=True)
    local_tasks.kill(b, no_restart=False)
    time.sleep(0.3)
    info2 = local_tasks.actor_info(b._actor_id, wait_ready=True)
    assert info2["state"] == "ALIVE" and info2["restarts"] == 1 and info2["pid"] != info["pid"]
    assert local_tasks.get(b.add.remote(1), timeout=60) == 8
