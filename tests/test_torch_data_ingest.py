"""Ingest through the port's trainer: ``streaming_split`` states and
resumes against the JAX package's, ``TorchTrainer(datasets=)``, and ingest
that resumes exactly after a death and across an elastic step-down.

* For the same block layout (``from_items``, whose blocks keep their
  order) and the same consumption, each package's split shards yield the
  same ids and the same ``state_dict()``; a resume from those states
  (2 -> 3, 3 -> 1, and a resume of a resumed run) yields the same ids in
  both, and each package resumes from the other's states
  (tests/test_checkpoint_commit.py:238-335 and :447-482).
* ``TorchTrainer(datasets=)`` on two CPU workers sees every row once
  (tests/test_data.py:222-247), and commits ``ingest.json`` in the
  reference's layout: equal to the record the reference's ``JaxTrainer``
  commits for the same run.
* A worker killed mid-epoch: the re-formed gang, at the same size or
  stepped down from 4 to 3 (item 4c's churn, a slot held), delivers every
  row, with at most 3 batches a rank of the first gang read twice
  (tests/test_train_elastic.py:180-183).
* The local store leaves no file after shutdown, removes a dead process's
  store, and a data worker sees no CUDA device.

The trainer's gang members are runtime actors (the module boots one
cluster); the shards they read are still the local task layer's
(``_private/local_tasks.py``), which any process of the host can read.
"""

import json
import os
import pickle

import numpy as np
import pytest

import _torch_data_apps as apps
import _torch_runtime as runtime
import ray_tpu.data as rd_ref
from _torch_trainer_apps import elastic_fit
from ray_tpu_torch import data as rd
from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.train import release_loops
from ray_tpu_torch.train.checkpoint import INGEST_FILE, StorageContext
from ray_tpu_torch.train.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import TorchTrainer


# The trainer's gangs run on a cluster of the module's, with four
# trainslots for the elastic case.
slots = runtime.cluster_fixture(autouse=True, num_cpus=8, resources={"trainslot": 4})


@pytest.fixture(scope="module")
def pool(ray_start_shared):
    runtime = local_tasks.init(num_workers=2)
    yield runtime
    store = runtime.store.dir
    local_tasks.shutdown()
    assert not os.path.exists(store)


def _layout(mod, n: int, blocks: int):
    return mod.from_items([{"id": i} for i in range(n)], parallelism=blocks).materialize()


def _consume(iterator, batches: int, batch_size: int) -> list:
    out = []
    it = iterator.iter_batches(batch_size=batch_size, batch_format="numpy")
    for _ in range(batches):
        try:
            out += [int(x) for x in next(it)["id"]]
        except StopIteration:
            break
    return out


def _rest(iterators, batch_size: int) -> list:
    return [[int(x) for b in it.iter_batches(batch_size=batch_size) for x in b["id"]]
            for it in iterators]


# (rows, blocks, first world, batches each rank reads, batch, resumed world)
RESUMES = {"2_to_3": (100, 5, 2, 3, 8, 3), "3_to_1": (96, 6, 3, 2, 4, 1),
           "2_to_2": (100, 5, 2, 3, 8, 2)}


@pytest.mark.parametrize("case", sorted(RESUMES))
def test_split_states_and_resumes_equal_the_reference(pool, case):
    n, blocks, world, batches, batch_size, new_world = RESUMES[case]
    port_ds, ref_ds = _layout(rd, n, blocks), _layout(rd_ref, n, blocks)
    port = port_ds.streaming_split(world)
    ref = ref_ds.streaming_split(world)
    assert all(s.supports_state for s in port)
    seen = [_consume(s, batches, batch_size) for s in port]
    assert seen == [_consume(s, batches, batch_size) for s in ref]
    states = [s.state_dict() for s in port]
    assert states == [s.state_dict() for s in ref]
    assert json.loads(json.dumps(states)) == states  # the record goes as JSON
    resume = {"world_size": world, "per_rank": states}
    port_rest = _rest(port_ds.streaming_split(new_world, resume_from=resume), batch_size)
    assert port_rest == _rest(ref_ds.streaming_split(new_world, resume_from=resume), batch_size)
    assert len(port_rest) == new_world
    # No row dropped, none read twice.
    assert sorted(i for ids in seen + port_rest for i in ids) == list(range(n))
    # The interchange: each package resumes from the other's states.
    ref_states = [s.state_dict() for s in ref]
    assert _rest(port_ds.streaming_split(new_world, resume_from={
        "world_size": world, "per_rank": ref_states}), batch_size) == port_rest


def test_a_resumed_resume_equals_the_reference(pool):
    port_ds, ref_ds = _layout(rd, 96, 6), _layout(rd_ref, 96, 6)
    outs = []
    for ds in (port_ds, ref_ds):
        first = ds.streaming_split(3)
        seen = [i for s in first for i in _consume(s, 2, 4)]
        resumed = ds.streaming_split(2, resume_from={
            "world_size": 3, "per_rank": [s.state_dict() for s in first]})
        seen += [i for s in resumed for i in _consume(s, 3, 4)]
        states = [s.state_dict() for s in resumed]
        again = ds.streaming_split(1, resume_from={"world_size": 2, "per_rank": states})
        rest = _rest(again, 16)[0]
        outs.append((states, seen, rest))
        assert sorted(seen + rest) == list(range(96))
    assert outs[0] == outs[1]


def test_epoch_advances_and_resume_is_one_shot(pool):
    ds = _layout(rd, 20, 2)
    shard = ds.streaming_split(1)[0]
    assert sorted(i for r in _rest([shard], 8) for i in r) == list(range(20))
    assert shard.state_dict()["epoch"] == 1 and shard.state_dict()["rows"] == 0
    shard2 = ds.streaming_split(1)[0]
    got = _consume(shard2, 1, 6)
    shard3 = ds.streaming_split(1, resume_from={"world_size": 1,
                                                "per_rank": [shard2.state_dict()]})[0]
    assert sorted(got + _rest([shard3], 6)[0]) == list(range(20))
    assert sorted(_rest([shard3], 6)[0]) == list(range(20))  # the next epoch is whole


def test_split_iterators_pickle_and_factory_iterators_hold_no_state(pool):
    ds = _layout(rd, 30, 3)
    shard = ds.streaming_split(2)[1]
    _consume(shard, 1, 4)
    copy = pickle.loads(pickle.dumps(shard))
    assert copy.state_dict() == shard.state_dict()
    it = rd.range(10, parallelism=1).iterator()
    assert not it.supports_state
    with pytest.raises(ValueError):
        it.load_state_dict({"epoch": 0, "rows": 0, "spans": []})


def test_trainer_datasets_see_every_row_once(pool, tmp_path):
    log_dir = tmp_path / "logs"
    log_dir.mkdir()
    result = TorchTrainer(
        apps.sum_loop, train_loop_config={"log_dir": str(log_dir)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
        datasets={"train": rd.range(64, parallelism=4), "plain": [1, 2, 3]}).fit()
    assert result.error is None, result.error
    ids = [i for r in range(2) for i in json.loads((log_dir / f"rank{r}.json").read_text())]
    assert sorted(ids) == list(range(64))
    assert result.metrics["fetch_wait_s"] >= 0
    # The flight recorder reads the shard's data-wait clock.
    assert all("data_wait_s" in rec for recs in result.step_stats.values() for rec in recs)


def _committed_ingest(storage_path: str, name: str) -> dict:
    return StorageContext(storage_path, name).latest_ingest()


def test_committed_ingest_record_equals_the_reference(pool, tmp_path):
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import RunConfig as RefRunConfig
    from ray_tpu.train import ScalingConfig as RefScalingConfig

    config = {"batch_size": 8, "log_dir": str(tmp_path), "pid_dir": str(tmp_path)}
    port = TorchTrainer(apps.ingest_loop, train_loop_config=config,
                        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
                        run_config=RunConfig(name="port", storage_path=str(tmp_path)),
                        datasets={"train": _layout(rd, 40, 4)}).fit()
    ref = JaxTrainer(apps.ingest_loop_ref, train_loop_config=config,
                     scaling_config=RefScalingConfig(num_workers=2),
                     run_config=RefRunConfig(name="ref", storage_path=str(tmp_path)),
                     datasets={"train": _layout(rd_ref, 40, 4)}).fit()
    assert port.error is None and ref.error is None
    got = json.loads((tmp_path / "port" / os.path.basename(port.checkpoint.path)
                      / INGEST_FILE).read_text())
    assert got == _committed_ingest(str(tmp_path), "port")
    want = json.loads(open(os.path.join(ref.checkpoint.path, "ingest.json")).read())
    assert got == want
    assert set(got) == {"world_size", "datasets"} and len(got["datasets"]["train"]) == 2


def test_a_death_mid_epoch_resumes_exactly(pool, tmp_path):
    n, batch = 96, 8
    log_dir = tmp_path / "logs"
    log_dir.mkdir()
    result = TorchTrainer(
        apps.ingest_loop,
        train_loop_config={"batch_size": batch, "kill_step": 2, "marker": str(tmp_path / "k"),
                           "log_dir": str(log_dir)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="ingest-equal", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)),
        datasets={"train": rd.range(n, parallelism=4).materialize()}).fit()
    assert result.error is None, result.error
    assert os.path.exists(tmp_path / "k")
    assert [r["reason"] for r in result.resizes] == ["gang_died"]
    ids = apps.logged_ids(str(log_dir))
    assert sorted(set(ids)) == list(range(n))
    assert len(ids) - n <= 3 * batch * 2


def test_an_elastic_step_down_mid_epoch_resumes_exactly(pool, tmp_path, slots):
    """Item 4c's churn on an ingest loop: rank 3 is killed at step 1 and
    its slot held, so the gang re-forms at 3 over the rows left."""
    n, batch = 96, 8
    log_dir = tmp_path / "logs"
    log_dir.mkdir()
    churn = release_loops.Churn(str(tmp_path), kill_step=1, restore=False)
    try:
        result = elastic_fit(tmp_path, "ingest-shrunk", apps.ingest_loop,
                             {"batch_size": batch, "log_dir": str(log_dir)}, [churn],
                             probe_s=0.0, datasets={"train": rd.range(n, parallelism=4)})
    finally:
        churn.release()
    assert result.error is None, result.error
    assert [(r["reason"], r["from"]) for r in result.resizes] == [("gang_died", 4)]
    assert result.metrics["world_size"] == 3 and result.metrics.get("epoch_done") is True
    ids = apps.logged_ids(str(log_dir))
    assert sorted(set(ids)) == list(range(n))
    assert len(ids) - n <= 3 * batch * 4
    ingest = _committed_ingest(str(tmp_path / "runs"), "ingest-shrunk")
    assert ingest["world_size"] == 3 and len(ingest["datasets"]["train"]) == 3


def test_store_leaves_nothing_and_workers_see_no_cuda(pool, tmp_path):
    env = rd.range(4, parallelism=2).map_batches(apps.worker_env).take_all()
    assert {row["cuda_visible"] for row in env} == {""}
    assert not any(row["torch"] for row in env)  # the package's import pulls no torch
    # A store whose process is gone is removed by the next store started.
    root = tmp_path / "root"
    dead = root / f"{local_tasks.STORE_PREFIX}999999999_0000"
    dead.mkdir(parents=True)
    (dead / "object").write_bytes(b"x")
    store = local_tasks._Store(str(root))
    assert not dead.exists() and os.path.isdir(store.dir)
    store.remove()
    assert os.listdir(root) == []
    # An object goes with the last ref to it.
    ref = local_tasks.put(np.arange(10))
    path = ref.path
    assert os.path.exists(path)
    del ref
    assert not os.path.exists(path)
