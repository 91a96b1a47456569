"""The port's ``TorchTrainer`` on two CPU workers (gloo), against the JAX
package's sharded step and the reference trainer's semantics.

The loop trains ``TransformerConfig.tiny()`` with AdamW as
``optax.adamw(3e-4)`` through ``setup_sharded_training`` on the session's
mesh ({dp 2}) and ``build_sharded_train_step``, reports each step's loss
and saves through ``save_sharded_state`` at step 2. Each step's batch
comes from a generator seeded by the step's index, so a resumed run sees
the same data.

  * The reported losses of an uninterrupted run match JAX's dp-2 sharded
    step for three steps.
  * A worker killed after step 3's report: the gang restarts from the
    step-2 checkpoint, and the final params equal the uninterrupted run's
    bitwise.
  * ``resume_from_checkpoint`` continues from a given checkpoint;
    ``max_failures=0`` surfaces the death; an exception in the loop ends
    the run with that error and no restart, as the reference's does.
  * ``RunConfig.callbacks``' ``on_result`` fires once a round with the
    round's metrics, and a ``RunConfig.stop`` bound ends the run at the
    round where the reference's ``JaxTrainer`` ends it (on a local
    cluster, ``ray_start_shared``), for the same loop.

The gang's members are runtime actors: the module boots one cluster
(``ray_tpu_torch.init``) for every test. On a machine with four cards,
``test_trainer_on_four_cards`` runs the restart case on NCCL workers, one
a card; elsewhere it skips.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel.mesh import tree_leaves, tree_map
from ray_tpu_torch.train import session, torch_utils
from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.step import make_optimizer
from ray_tpu_torch.train.trainer import TorchTrainer
from ray_tpu_torch.util.gang import GangDiedError, WorkerError

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_runtime as runtime  # noqa: E402

cluster = runtime.cluster_fixture(
    autouse=True, num_cpus=4, num_gpus=torch.cuda.device_count() or None)

STEPS = 4
# tests/test_torch_train.py's bound on a trajectory's losses against JAX's.
TRAJECTORY_LOSS_TOL = 1e-4


def _batch(step: int) -> np.ndarray:
    return np.random.default_rng(1000 + step).integers(0, 256, (4, 17)).astype(np.int32)


def _train_loop(config):
    """One worker's loop (module level: the gang pickles it by name)."""
    ctx = session.get_context()
    model = pt.TransformerConfig.tiny()
    init = config["init"]

    def init_fn(device):
        if device == "meta":
            return tree_map(lambda a: torch.empty(a.shape, device="meta"), init)
        return params_from_numpy(init, device=device)

    setup = torch_utils.setup_sharded_training(init_fn, make_optimizer,
                                               logical_dims=pt.param_logical_dims(model))
    step = torch_utils.build_sharded_train_step(
        lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], model), setup)
    start, resumed = 0, session.get_checkpoint()
    if resumed is not None:
        _, _, extra = torch_utils.restore_sharded_state(resumed, setup)
        start = extra["step"]
    if config.get("raise_at") == start + 1 and ctx.world_rank == 1:
        raise KeyError("raised in the loop")
    params, opt = setup.params, setup.opt_state
    for i in range(start, config["steps"]):
        params, opt, loss = step(params, opt, setup.shard_batch(torch.from_numpy(_batch(i))))
        checkpoint = None
        if i + 1 == config["save_at"]:
            checkpoint = torch_utils.save_sharded_state(params, opt, extra={"step": i + 1})
        session.report({"step": i + 1, "loss": float(loss)}, checkpoint=checkpoint)
        if config.get("die_after") == i + 1 and resumed is None and ctx.world_rank == 1:
            os._exit(1)
    full = {"/".join(path): leaf.full_tensor().detach().cpu().numpy().copy()
            for path, leaf in tree_leaves(params)}
    if ctx.world_rank == 0:
        np.savez(config["out"], **full)


@pytest.fixture(scope="module")
def init_tree():
    import jax

    from ray_tpu.models import transformer as jt

    jax.config.update("jax_threefry_partitionable", True)
    return jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(
        jt.TransformerConfig.tiny(), jax.random.PRNGKey(0)))


def _fit(tmp_path, name, init_tree, max_failures=1, use_gpu=False, workers=2, resume=None,
         **loop):
    out = str(tmp_path / f"{name}.npz")
    trainer = TorchTrainer(
        _train_loop,
        train_loop_config={"init": init_tree, "steps": STEPS, "save_at": 2, "out": out, **loop},
        scaling_config=ScalingConfig(num_workers=workers, use_gpu=use_gpu),
        run_config=RunConfig(name=name, storage_path=str(tmp_path / "runs"),
                             failure_config=FailureConfig(max_failures=max_failures),
                             checkpoint_config=CheckpointConfig(num_to_keep=1)),
        resume_from_checkpoint=resume)
    return trainer.fit(), out


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory, init_tree):
    tmp = tmp_path_factory.mktemp("trainer")
    result, out = _fit(tmp, "whole", init_tree)
    return result, dict(np.load(out))


def _jax_losses(init_tree, devices, steps):
    import jax
    import optax

    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.train import jax_utils

    config = jt.TransformerConfig.tiny()
    opt = optax.adamw(3e-4)
    setup = jax_utils.setup_sharded_training(
        lambda: jt.init_params(config, jax.random.PRNGKey(0)), opt,
        mesh=JaxMeshSpec({"dp": 2}).build(devices[:2]), logical_dims=jt.param_logical_dims(config))
    step = jax_utils.build_sharded_train_step(
        lambda p, tok: jt.loss_fn(p, tok[:, :-1], tok[:, 1:], config), opt, setup)
    params, opt_state, losses = setup.params, setup.opt_state, []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, setup.shard_batch(_batch(i)))
        losses.append(float(loss))
    return losses


def test_reported_losses_match_jax(uninterrupted, init_tree, cpu_mesh_devices):
    result, _ = uninterrupted
    assert result.error is None and not result.resizes
    assert [m["step"] for m in result.metrics_history] == [1, 2, 3, 4]
    assert result.metrics_history[0]["factorization"] == {"dp": 2, "fsdp": 1, "tp": 1, "pp": 1}
    losses = [m["loss"] for m in result.metrics_history]
    want = _jax_losses(init_tree, cpu_mesh_devices, 3)
    np.testing.assert_allclose(losses[:3], want, rtol=0, atol=TRAJECTORY_LOSS_TOL)
    # The step-2 checkpoint was committed; num_to_keep=1 kept it alone.
    assert os.path.basename(result.checkpoint.path) == "checkpoint_000000"
    assert result.metrics_history[1]["checkpoint_path"] == result.checkpoint.path


def test_killed_worker_restarts_from_the_checkpoint(uninterrupted, init_tree, tmp_path):
    """Rank 1 exits hard after step 3's report: the gang restarts from the
    step-2 checkpoint (AdamW's step count with it) and ends bitwise where
    the uninterrupted run ends."""
    whole, whole_params = uninterrupted
    result, out = _fit(tmp_path, "killed", init_tree, die_after=3)
    assert result.error is None
    assert len(result.resizes) == 1 and result.resizes[0]["reason"] == "gang_died"
    assert [a["ended_by"] for a in result.attempts] == ["gang_died", "done"]
    assert [m["step"] for m in result.metrics_history] == [1, 2, 3, 3, 4]
    assert [m["loss"] for m in result.metrics_history[3:]] == \
        [m["loss"] for m in whole.metrics_history[2:]]
    params = dict(np.load(out))
    assert params.keys() == whole_params.keys()
    for name, value in params.items():
        np.testing.assert_array_equal(value, whole_params[name], err_msg=name)


def test_resume_from_checkpoint(uninterrupted, init_tree, tmp_path):
    """A new run given the uninterrupted run's step-2 checkpoint takes steps
    3 and 4 and ends bitwise where that run ended."""
    whole, whole_params = uninterrupted
    result, out = _fit(tmp_path, "resumed", init_tree, resume=whole.checkpoint)
    assert result.error is None and not result.resizes
    assert [m["step"] for m in result.metrics_history] == [3, 4]
    for name, value in np.load(out).items():
        np.testing.assert_array_equal(value, whole_params[name], err_msg=name)


def test_max_failures_zero_surfaces_the_death(init_tree, tmp_path):
    result, _ = _fit(tmp_path, "fail_fast", init_tree, max_failures=0, die_after=1)
    assert isinstance(result.error, GangDiedError)
    assert not result.resizes and [m["step"] for m in result.metrics_history] == [1]


def test_an_exception_in_the_loop_ends_the_run(init_tree, tmp_path):
    result, _ = _fit(tmp_path, "raises", init_tree, raise_at=1)
    assert isinstance(result.error, WorkerError) and "raised in the loop" in str(result.error)
    assert not result.resizes and result.metrics_history == []


@pytest.mark.cuda
def test_trainer_on_four_cards(tmp_path):
    """Four NCCL workers, one a card: the killed run's final params equal
    the uninterrupted run's bitwise. (No JAX there: the port's own init.)"""
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA cards, found {torch.cuda.device_count()}")
    from ray_tpu_torch import _build

    _build.library()  # built once here, loaded by every worker
    init_tree = tree_map(lambda t: t.numpy(), pt.init_params(pt.TransformerConfig.tiny(), 0,
                                                             "cpu"))
    whole, whole_out = _fit(tmp_path, "whole4", init_tree, use_gpu=True, workers=4)
    result, out = _fit(tmp_path, "killed4", init_tree, use_gpu=True, workers=4, die_after=3)
    assert whole.error is None and not whole.resizes
    assert result.error is None and len(result.resizes) == 1
    whole = dict(np.load(whole_out))
    for name, value in np.load(out).items():
        np.testing.assert_array_equal(value, whole[name], err_msg=name)


def _rounds_loop(config):
    """Reports rounds 1..config["rounds"] through the train session live in
    this process: a TorchTrainer gang member's or a JaxTrainer worker's."""
    import sys

    port = sys.modules.get("ray_tpu_torch.train.session")
    if port is not None and port.in_session():
        report = port.report
    else:
        from ray_tpu.train import report
    for i in range(1, config["rounds"] + 1):
        report({"round": i, "score": 0.5 * i})


class _Recorder:
    """A RunConfig callback: the metrics of each round."""

    def __init__(self):
        self.seen = []

    def on_result(self, metrics):
        self.seen.append(dict(metrics))


@pytest.mark.parametrize("stop", [None, {"score": 1.5}, {"round": 4, "absent": 0}],
                         ids=["no_stop", "score", "round"])
def test_callbacks_and_stop_match_the_reference(ray_start_shared, tmp_path, stop):
    """on_result fires once a round with that round's metrics, and a stop
    bound ends the run at the round where the reference's JaxTrainer ends
    it, for the same loop."""
    import ray_tpu.train as ref_train

    runs = {}
    for name in ("ref", "port"):
        recorder = _Recorder()
        if name == "ref":
            trainer = ref_train.JaxTrainer(
                _rounds_loop, train_loop_config={"rounds": 5},
                scaling_config=ref_train.ScalingConfig(num_workers=2),
                run_config=ref_train.RunConfig(name=name, storage_path=str(tmp_path),
                                               callbacks=[recorder], stop=stop))
        else:
            trainer = TorchTrainer(
                _rounds_loop, train_loop_config={"rounds": 5},
                scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
                run_config=RunConfig(name=name, storage_path=str(tmp_path),
                                     callbacks=[recorder], stop=stop))
        result = trainer.fit()
        assert result.error is None
        assert recorder.seen == result.metrics_history
        runs[name] = [(m["round"], m["score"]) for m in recorder.seen]
    assert runs["port"] == runs["ref"]
    assert len(runs["port"]) == {None: 5, 1.5: 3, 4: 4}[stop and next(iter(stop.values()))]
