"""Elastic step-down and grow-back: the port's ``TorchTrainer`` against
the JAX package's ``JaxTrainer``, each run here.

The reference runs as its own tests run it (tests/test_train_elastic.py:
its loop, its callbacks and its trainer settings) on an in-process
cluster of four one-``trainslot`` nodes, where a node is removed at step
1 and, for the grow-back, added again once the gang runs at 3. The port
runs the same loop on a gloo gang whose workers lease a CPU and one of
four ``trainslot``s declared on its cluster (``ray_tpu_torch.init``); the
churn callback kills rank 3's process at step 1 and holds its slot from an
actor, and gives it back once the gang runs at 3. Each test holds the port to the reference's run:
``Result.resizes`` (reason, from, to), the world sizes its gangs reported
in order, and the last report's step, world size and ``resumed``.

A module of its own: ``ray_start_cluster`` makes a cluster a test, which
cannot share a module with ``ray_start_shared``.
"""

import _torch_runtime as runtime
import _torch_trainer_apps as apps
import ray_tpu_torch as rt
from _torch_trainer_apps import elastic_fit, slots, transitions, worlds  # noqa: F401 (a fixture)
from ray_tpu_torch.train import release_loops


def _reference(cluster, tmp_path, name, steps, callback_cls, probe_s=None):
    """tests/test_train_elastic.py's step-down (``_KillNodeAt``) or
    grow-back (``_ChurnAndRestore``) run, as that test makes it."""
    from test_train_elastic import _elastic_loop

    from ray_tpu.train import FailureConfig, JaxTrainer, RunConfig, ScalingConfig

    nodes = [cluster.add_node(resources={"trainslot": 1}, num_cpus=2) for _ in range(4)]
    cluster.wait_for_nodes(5)
    callback = callback_cls(cluster, trigger_step=1)
    callback.victim = nodes[-1]
    extra = {} if probe_s is None else {"elastic_grow_probe_period_s": probe_s}
    return JaxTrainer(
        _elastic_loop, train_loop_config={"steps": steps},
        scaling_config=ScalingConfig(num_workers=4, min_workers=2,
                                     resources_per_worker={"CPU": 1, "trainslot": 1},
                                     placement_strategy="PACK",
                                     elastic_formation_timeout_s=10.0, **extra),
        run_config=RunConfig(name=name, storage_path=str(tmp_path / "ref"),
                             failure_config=FailureConfig(max_failures=2),
                             callbacks=[callback])).fit()


def _same_run(port, ref) -> None:
    assert ref.error is None, ref.error
    assert port.error is None, port.error
    assert transitions(port) == transitions(ref)
    assert worlds(port) == worlds(ref)
    for key in ("step", "world_size", "resumed"):
        assert port.metrics[key] == ref.metrics[key], key


def test_step_down_when_a_slot_is_held(ray_start_cluster, tmp_path, slots):
    from test_train_elastic import _KillNodeAt

    ref = _reference(ray_start_cluster, tmp_path, "step-down", 8, _KillNodeAt)
    free = rt.available_resources()
    churn = release_loops.Churn(str(tmp_path), kill_step=1, restore=False)
    port = elastic_fit(tmp_path, "step-down", apps.elastic_loop, {"steps": 8}, [churn])
    churn.release()
    _same_run(port, ref)
    # The reference test's own asserts: all steps, resumed, at 3.
    assert port.metrics["step"] == 7 and port.metrics["resumed"] is True
    assert port.metrics["world_size"] == 3
    assert transitions(port) == [{"reason": "gang_died", "from": 4, "to": None}]
    assert [a.get("world_size") for a in port.attempts] == [4, 3]
    assert runtime.settled(free) and rt.available_resources()["trainslot"] == 4


def test_grow_back_when_the_slot_frees(ray_start_cluster, tmp_path, slots):
    from test_train_elastic import _ChurnAndRestore

    ref = _reference(ray_start_cluster, tmp_path, "grow-back", 12, _ChurnAndRestore,
                     probe_s=0.01)
    free = rt.available_resources()
    churn = release_loops.Churn(str(tmp_path), kill_step=1)
    port = elastic_fit(tmp_path, "grow-back", apps.elastic_loop, {"steps": 12}, [churn],
                       probe_s=0.01)
    _same_run(port, ref)
    assert port.metrics["step"] == 11 and port.metrics["world_size"] == 4
    assert transitions(port) == [{"reason": "gang_died", "from": 4, "to": None},
                                 {"reason": "grow", "from": 3, "to": 4}]
    assert [a.get("world_size") for a in port.attempts] == [4, 3, 4]
    assert [a["ended_by"] for a in port.attempts] == ["gang_died", "grow", "done"]
    # Each gang reports the factorization of its own world.
    dps = {m["world_size"]: m["factorization"]["dp"] for m in port.metrics_history}
    assert dps == {4: 4, 3: 3}
    assert runtime.settled(free) and rt.available_resources()["trainslot"] == 4
