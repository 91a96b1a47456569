"""BASELINE config 1 (release/train_fashion_mnist.py) through the port's
``TorchTrainer`` against the reference's ``JaxTrainer`` on a local cluster
(``ray_start_shared``), on the CPU.

Both run the release script's loop (the JAX loop as the script has it in
``tests/_torch_trainer_apps.py``, the port's in
``ray_tpu_torch.train.release_loops``): two workers,
``CNNConfig()``, batch 64 of images and labels from
``np.random.default_rng(rank)``, Adam at 1e-3, one warm-up step then
``STEPS`` steps, one report of ``img_per_s``, ``loss`` and ``acc`` with a
checkpoint of the params. The port's loop starts from the reference's
``init_cnn(CNNConfig(), PRNGKey(0))`` params, carried across as numpy.
Each rank's reported loss and accuracy and its final params agree with
the reference's within the bounds below (rank 1's come through per-rank
files the loops write); each trainer's committed checkpoint holds the
params of the rank it commits (the port rank 0's, the reference the last
writer's).
"""

import json

import jax
import numpy as np
import pytest

import _torch_trainer_apps as apps
from ray_tpu.models import cnn as jc
from ray_tpu_torch.models.convert import conv_params_to_numpy
from ray_tpu_torch.train import release_loops
from ray_tpu_torch.train.checkpoint import load_pytree_checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import TorchTrainer

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

STEPS = 4
LR, BATCH = 1e-3, 64
# tests/test_torch_cnn.py's f32 bound on a loss (over max(1, |loss|)), as
# chip_smoke.py's config-3 check holds its Adam trajectory's losses; the
# accuracy must be equal.
F32_TOL = 2e-5
# The params after STEPS + 1 Adam steps: each step moves a parameter by at
# most lr, and a gradient component that is rounding noise in one package
# can take the other sign in the other, so the bound is Adam's: 2 lr a
# step. The relative (Frobenius) error over the whole tree is held to the
# gradient bound of tests/test_torch_cnn.py.
PARAM_ABS_TOL = 2 * LR * (STEPS + 1)
PARAM_REL_TOL = 2e-4


def _ranks(out_dir) -> list:
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2)]


def test_config1_through_the_trainer_matches_the_reference(ray_start_shared, tmp_path):
    from ray_tpu import train as ref_train
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import RunConfig as RefRunConfig
    from ray_tpu.train import ScalingConfig as RefScalingConfig

    config = {"lr": LR, "batch_size": BATCH, "steps": STEPS}
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = JaxTrainer(apps.fashion_mnist_loop_ref,
                     train_loop_config={**config, "out_dir": str(tmp_path / "ref")},
                     scaling_config=RefScalingConfig(num_workers=2),
                     run_config=RefRunConfig(name="fmnist_ref", storage_path=str(tmp_path))
                     ).fit()
    init = jax.tree.map(np.asarray, jc.init_cnn(jc.CNNConfig(), jax.random.PRNGKey(0)))
    port = TorchTrainer(release_loops.fashion_mnist_loop,
                        train_loop_config={**config, "params": init,
                                           "out_dir": str(tmp_path / "port")},
                        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
                        run_config=RunConfig(name="fmnist_port", storage_path=str(tmp_path))
                        ).fit()
    assert ref.error is None and port.error is None, (ref.error, port.error)
    assert set(port.metrics) >= {"img_per_s", "loss", "acc"}
    assert port.metrics["img_per_s"] > 0
    for rank, (r, p) in enumerate(zip(_ranks(tmp_path / "ref"), _ranks(tmp_path / "port"))):
        assert abs(p["loss"] - r["loss"]) / max(1.0, abs(r["loss"])) < F32_TOL, rank
        assert p["acc"] == r["acc"], rank
    assert port.metrics["loss"] == _ranks(tmp_path / "port")[0]["loss"]

    # Each rank's final params, the port's against the reference's.
    init_flat = release_loops.flat(init)
    for rank in range(2):
        ref_rank = dict(np.load(tmp_path / "ref" / f"rank{rank}.npz"))
        port_rank = dict(np.load(tmp_path / "port" / f"rank{rank}.npz"))
        assert sorted(port_rank) == sorted(ref_rank) == sorted(init_flat)
        assert max(float(np.abs(ref_rank[k] - init_flat[k]).max()) for k in init_flat) > LR
        for k in init_flat:
            assert float(np.abs(port_rank[k] - ref_rank[k]).max()) <= PARAM_ABS_TOL, (rank, k)
        num = np.sqrt(sum(float(np.sum((port_rank[k] - ref_rank[k]) ** 2)) for k in init_flat))
        den = np.sqrt(sum(float(np.sum(ref_rank[k] ** 2)) for k in init_flat))
        assert num / den < PARAM_REL_TOL, rank

    # The committed checkpoints. Each rank saves its own params (the loop
    # syncs no gradients, so they differ). The port commits rank 0's, the
    # canonical writer; the reference's loader assembles every writer's
    # copy in turn, so the last one, rank 1's, is what it committed.
    ref_params, ref_extra = ref_train.load_pytree_checkpoint(ref.checkpoint)
    port_params, port_extra = load_pytree_checkpoint(port.checkpoint)
    assert ref_extra == port_extra == {"step": STEPS}
    for tree, out_dir, rank in ((conv_params_to_numpy(port_params), "port", 0),
                                (jax.device_get(ref_params), "ref", 1)):
        written = dict(np.load(tmp_path / out_dir / f"rank{rank}.npz"))
        committed = release_loops.flat(tree)
        assert sorted(committed) == sorted(written)
        for k, value in committed.items():
            np.testing.assert_array_equal(value, written[k], err_msg=f"{out_dir} {k}")


@pytest.mark.parametrize("workers", [1, 2])
def test_config1_reports_once_with_a_checkpoint(tmp_path, workers):
    """The port's loop alone at one and two workers: one round, rank 0's
    metrics, img/s counted over every worker's images."""
    init = jax.tree.map(np.asarray, jc.init_cnn(jc.CNNConfig(), jax.random.PRNGKey(0)))
    result = TorchTrainer(release_loops.fashion_mnist_loop,
                          train_loop_config={"lr": LR, "batch_size": 8, "steps": 1,
                                             "params": init, "logits": True},
                          scaling_config=ScalingConfig(num_workers=workers, use_gpu=False),
                          run_config=RunConfig(name=f"fmnist{workers}",
                                               storage_path=str(tmp_path))).fit()
    assert result.error is None and len(result.metrics_history) == 1
    assert np.asarray(result.metrics["first_logits"]).shape == (8, 10)
    assert result.checkpoint is not None and result.metrics["factorization"]["dp"] == workers
