"""Bounded elasticity in the port's ``TorchTrainer`` against the JAX
package's ``JaxTrainer``, on gloo gangs whose workers lease a CPU and one
of four declared ``trainslot``s from the node agent of the module's
cluster (``ray_tpu_torch.init``).

* ``ScalingConfig``'s elastic validation equals the reference's.
* release/benchmarks_elastic.py's churn at its smoke scale: the churned
  run's losses equal the port's undisturbed run's and the reference's
  undisturbed ``JaxTrainer`` run's (``ray_start_shared``) exactly, with
  the flight recorder's restart and stalled time above 0.
* An fsdp-sharded state committed at world 4 restores at world 2 bitwise
  through ``restore_sharded_state``.
* On four cards (``cuda``-marked, skipped elsewhere): with one card leased
  by another actor, a gang of three NCCL workers runs on the other three
  and grows back to four when the card frees.

Step-down and grow-back against the reference's own runs are
``tests/test_torch_elastic_resize.py``: the reference needs an in-process
cluster a test, which cannot share a module with ``ray_start_shared``.
"""

import numpy as np
import pytest
import torch

import _torch_runtime as runtime
import _torch_trainer_apps as apps
import ray_tpu_torch as rt
from _torch_trainer_apps import elastic_fit, slots, transitions  # noqa: F401 (a fixture)
from ray_tpu_torch.train import release_loops
from ray_tpu_torch.train.config import ScalingConfig

# release/benchmarks_elastic.py at RAY_TPU_RELEASE_SMOKE=1.
CHURN_STEPS, CHURN_STEP_S, CHURN_KILL = 10, 0.05, 3


def test_scaling_config_elastic_validation_matches_the_reference():
    from ray_tpu.train import ScalingConfig as RefScalingConfig

    for cls in (RefScalingConfig, ScalingConfig):
        with pytest.raises(ValueError):
            cls(num_workers=2, min_workers=3)
        with pytest.raises(ValueError):
            cls(num_workers=2, min_workers=0)
        assert cls(num_workers=4, min_workers=2).elastic
        assert not cls(num_workers=4).elastic
        assert not cls(num_workers=4, min_workers=4).elastic
    for kwargs in ({}, {"resources_per_worker": {"trainslot": 1}}):
        assert ScalingConfig(num_workers=2, use_gpu=False, **kwargs).worker_resources() == \
            RefScalingConfig(num_workers=2, **kwargs).worker_resources()
    assert ScalingConfig(num_workers=2, use_gpu=True).worker_resources() == {"CPU": 1, "GPU": 1}
    assert ScalingConfig(num_workers=4).factorization(3)["dp"] == 3
    with pytest.raises(NotImplementedError, match="item 14"):
        ScalingConfig(num_workers=2, drain_on_oom_risk=True)


def test_churned_quadratic_equals_the_undisturbed_runs(ray_start_shared, tmp_path, slots):
    free = rt.available_resources()
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import RunConfig as RefRunConfig
    from ray_tpu.train import ScalingConfig as RefScalingConfig

    config = {"steps": CHURN_STEPS, "step_time_s": CHURN_STEP_S}
    base = elastic_fit(tmp_path, "base", release_loops.quadratic_loop, config, [],
                       probe_s=0.05, max_failures=4)
    churn = release_loops.Churn(str(tmp_path), kill_step=CHURN_KILL)
    churned = elastic_fit(tmp_path, "churn", release_loops.quadratic_loop, config, [churn],
                          probe_s=0.05, max_failures=4)
    ref = JaxTrainer(apps.quadratic_loop_ref, train_loop_config=config,
                     scaling_config=RefScalingConfig(num_workers=4),
                     run_config=RefRunConfig(name="ref", storage_path=str(tmp_path / "ref"))
                     ).fit()
    assert base.error is None and churned.error is None and ref.error is None
    base_loss, churn_loss = release_loops.loss_by_step(base), release_loops.loss_by_step(churned)
    assert sorted(churn_loss) == list(range(CHURN_STEPS))
    loss_max_dev = max(abs(base_loss[s] - churn_loss[s]) for s in churn_loss)
    assert loss_max_dev == 0.0
    assert churn_loss == release_loops.loss_by_step(ref)
    reasons = [r["reason"] for r in churned.resizes]
    assert reasons == ["gang_died", "grow"] and churned.metrics["world_size"] == 4
    assert churned.metrics["step"] == CHURN_STEPS - 1
    # The recorder's buckets sum to the wall clock; the churn cost restart
    # (formation, backoff) and stalled (work lost) time.
    good = churned.goodput
    assert good["restart_s"] > 0 and good["stalled_s"] > 0
    assert abs(sum(good[k] for k in ("productive_s", "checkpoint_s", "restart_s", "stalled_s"))
               - good["wall_s"]) < 1e-9
    assert base.goodput["stalled_s"] == 0.0
    assert runtime.settled(free)


@pytest.fixture(scope="module")
def tiny_init():
    import jax

    from ray_tpu.models import transformer as jt

    jax.config.update("jax_threefry_partitionable", True)
    return jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(
        jt.TransformerConfig.tiny(), jax.random.PRNGKey(0)))


def test_fsdp_state_committed_at_four_restores_at_two(tmp_path, slots, tiny_init):
    """The tiny model on {fsdp 4} saves its sharded state at step 2; a
    worker dies and two slots stay held, so the gang re-forms at 2 on
    {fsdp 2}, where restore_sharded_state places every parameter and Adam
    moment bitwise as saved."""
    churn = release_loops.Churn(str(tmp_path), kill_step=2, hold=2, restore=False)
    result = elastic_fit(tmp_path, "fsdp", apps.fsdp_loop,
                      {"init": tiny_init, "steps": 3, "save_at": 2, "out_dir": str(tmp_path)},
                      [churn])
    churn.release()
    assert result.error is None, result.error
    assert [a.get("world_size") for a in result.attempts] == [4, 2]
    saved = dict(np.load(tmp_path / "saved_w4.npz"))
    restored = dict(np.load(tmp_path / "restored_w2.npz"))
    assert sorted(saved) == sorted(restored) and any(k.startswith("mu:") for k in saved)
    for name, value in saved.items():
        np.testing.assert_array_equal(restored[name], value, err_msg=name)
    assert [m["world_size"] for m in result.metrics_history] == [4, 4, 2]


class _Card:
    """An actor that holds a whole card."""

    def device(self) -> str:
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES", "")


@pytest.mark.cuda
def test_gang_on_four_cards_skips_a_leased_card_and_grows_back(tmp_path, slots):
    """Four cards, NCCL: one card leased by another actor when the gang
    forms, so three workers run on the other three (a dp all-reduce a
    step); the card frees and the gang grows back to four."""
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA cards, found {torch.cuda.device_count()}")
    holder = rt.remote(_Card).options(num_gpus=1).remote()
    held = int(rt.get(holder.device.remote(), timeout=120))
    churn = _ReleaseAt(holder, world=3)
    result = elastic_fit(tmp_path, "cards", apps.cards_loop, {"steps": 6}, [churn],
                         use_gpu=True, resources_per_worker={"CPU": 1}, probe_s=0.01)
    assert result.error is None, result.error
    first = [m for m in result.metrics_history if m["world_size"] == 3]
    assert first and held not in first[0]["cards"] and len(set(first[0]["cards"])) == 3
    assert result.metrics["world_size"] == 4
    assert sorted(result.metrics["cards"]) == [0, 1, 2, 3]
    assert transitions(result) == [{"reason": "grow", "from": 3, "to": 4}]


class _ReleaseAt:
    """Kills ``holder`` at the first round of a gang of ``world``."""

    def __init__(self, holder, world: int):
        self.holder, self.world = holder, world

    def on_result(self, metrics):
        if metrics["world_size"] == self.world and self.holder is not None:
            rt.kill(self.holder)
            self.holder = None
