"""The port's ``PipelineStageRunner`` under ``TorchTrainer`` against the JAX
package's fused trajectory.

As ``tests/test_train.py::test_trainer_mpmd_pipeline_matches_fused`` and
``tests/test_overlap.py::test_interleaved_pipeline_matches_fused`` run
the reference's: ``TorchTrainer(pipeline_stages=2, microbatches=4)`` on
two CPU workers (gloo), each running one stage's op stream with SGD(0.1)
on ``_pp_config()`` (2 layers; 4 for the interleaved case, virtual_stages
2) over three batches of ``_pp_batches()``:

  * the reported losses against JAX's fused, microbatched step from the
    same init at TRAJECTORY_LOSS_TOL, and against the port's own fused
    step at FUSED_LOSS_TOL, the reference's bound for its pipeline against
    its fused step;
  * each rank's ``TrainContext.pipeline`` as the reference's executor
    assigns it; the measured ``pp_bubble`` phase is reported;
  * the config's and the runner's refusals, as the reference's.

On a machine with two cards, ``test_pipeline_trainer_on_two_cards`` runs
both cases on NCCL workers, one a card; elsewhere it skips.
"""

import json
import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import _wire
from ray_tpu_torch.parallel.mesh import tree_leaves, tree_map
from ray_tpu_torch.train import session
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.stage_runner import PipelineStageRunner, microbatch_slicer
from ray_tpu_torch.train.trainer import TorchTrainer

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

# tests/test_torch_train.py's bound on a trajectory's losses against JAX's.
TRAJECTORY_LOSS_TOL = 1e-4
# The reference holds its pipeline to its fused step at rtol = atol = 2e-6.
FUSED_LOSS_TOL = 2e-6
MICRO, BATCHES = 4, 3


def _pp_batches(n=BATCHES):
    rng = np.random.default_rng(17)
    return [{"x": rng.integers(0, 64, (8, 16)).astype(np.int32),
             "y": rng.integers(0, 64, (8, 16)).astype(np.int32)} for _ in range(n)]


def _pp_config(module, dtype, n_layers=2):
    return module.TransformerConfig(vocab_size=64, dim=16, n_layers=n_layers, n_heads=2,
                                    n_kv_heads=2, hidden_dim=32, max_seq=16, dtype=dtype)


def _sgd(tree):
    return torch.optim.SGD([leaf for _, leaf in tree_leaves(tree)], lr=0.1)


# -------------------------------------------------------------- worker side
def _pp_loop(config):
    """One worker: one rank of the (possibly interleaved) pipeline."""
    ctx = session.get_context()
    cfg = _pp_config(pt, torch.float32, config["n_layers"])
    device = ctx.device or "cpu"
    stage, stages = ctx.pipeline["stage"], ctx.pipeline["num_stages"]
    virtual = ctx.pipeline["virtual"]
    with open(os.path.join(config["out_dir"], f"pipeline{ctx.world_rank}.json"), "w") as f:
        json.dump(ctx.pipeline, f)
    params = params_from_numpy(config["init"], device=device)
    chunks = pt.partition_stages(params, cfg, stages * virtual)

    def make_fn(vs):
        def fn(p, a):
            return pt.stage_forward(p, a, cfg, first=(vs == 0), last=False)
        return fn

    def last_fn(p, a, micro):
        return pt.logits_loss(pt.stage_forward(p, a, cfg, first=False, last=True), micro["y"])

    runner = PipelineStageRunner(
        ctx=ctx,
        stage_fn=[make_fn(c * stages + stage) for c in range(virtual)],
        last_stage_fn=last_fn,
        params=[tree_map(torch.clone, chunks[c * stages + stage]) for c in range(virtual)],
        optimizer=_sgd,
        activation_like=lambda micro: torch.empty(
            (*micro["y"].shape, cfg.dim), dtype=cfg.dtype, device="meta"),
        microbatch_fn=microbatch_slicer,
    )
    for batch in _pp_batches():
        loss = runner.train_step(batch)
        session.report({"loss": loss, "pp_bubble_s": runner.stats["pp_bubble"],
                        "step_s": runner.stats["step"]})


# -------------------------------------------------------------- parent side
def _init_tree(n_layers):
    import jax

    from ray_tpu.models import transformer as jt

    jax.config.update("jax_threefry_partitionable", True)
    cfg = _pp_config(jt, jax.numpy.float32, n_layers)
    return jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0)))


def _jax_fused_losses(n_layers):
    """The reference tests' fused baseline: microbatched gradient
    accumulation in one process."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import transformer as jt

    cfg = _pp_config(jt, jnp.float32, n_layers)
    jax.config.update("jax_threefry_partitionable", True)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    tx = optax.sgd(0.1)
    opt = tx.init(params)

    def mb_mean_loss(p, batch):
        losses = [jt.loss_fn(p, batch["x"][m * 2:(m + 1) * 2], batch["y"][m * 2:(m + 1) * 2],
                             cfg) for m in range(MICRO)]
        return jnp.mean(jnp.stack(losses))

    @jax.jit
    def fused_step(p, o, batch):
        loss, grads = jax.value_and_grad(mb_mean_loss)(p, batch)
        updates, o = tx.update(grads, o, p)
        return jax.tree.map(lambda w, u: w + u.astype(w.dtype), p, updates), o, loss

    out = []
    for batch in _pp_batches():
        params, opt, loss = fused_step(params, opt, batch)
        out.append(float(loss))
    return out


def _port_fused_losses(init, n_layers):
    cfg = _pp_config(pt, torch.float32, n_layers)
    params = params_from_numpy(init, device="cpu")
    for _, leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = _sgd(params)
    out = []
    for batch in _pp_batches():
        losses = [pt.loss_fn(params, batch["x"][m * 2:(m + 1) * 2],
                             batch["y"][m * 2:(m + 1) * 2], cfg) for m in range(MICRO)]
        loss = torch.stack(losses).mean()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        out.append(float(loss.detach()))
    return out


def _fit(tmp_path, name, n_layers, virtual, init, use_gpu=False):
    out_dir = tmp_path / name
    out_dir.mkdir()
    result = TorchTrainer(
        _pp_loop,
        train_loop_config={"n_layers": n_layers, "init": init, "out_dir": str(out_dir)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=use_gpu, pipeline_stages=2,
                                     microbatches=MICRO, virtual_stages=virtual),
        run_config=RunConfig(name=name, storage_path=str(tmp_path / "runs")),
    ).fit()
    contexts = [json.loads((out_dir / f"pipeline{r}.json").read_text()) for r in range(2)]
    return result, contexts


CASES = {"1f1b": (2, 1), "interleaved": (4, 2)}


@pytest.fixture(scope="module", params=list(CASES))
def pipeline_run(request, tmp_path_factory):
    n_layers, virtual = CASES[request.param]
    init = _init_tree(n_layers)
    result, contexts = _fit(tmp_path_factory.mktemp("stage_runner"), request.param, n_layers,
                            virtual, init)
    return request.param, result, contexts, init


def test_pipeline_trainer_matches_fused(pipeline_run):
    name, result, _, init = pipeline_run
    n_layers, _ = CASES[name]
    assert result.error is None, result.error
    assert result.metrics["factorization"] == {"dp": 1, "fsdp": 1, "tp": 1, "pp": 2}
    losses = [m["loss"] for m in result.metrics_history]
    assert len(losses) == BATCHES
    np.testing.assert_allclose(losses, _jax_fused_losses(n_layers), rtol=0,
                               atol=TRAJECTORY_LOSS_TOL)
    np.testing.assert_allclose(losses, _port_fused_losses(init, n_layers), rtol=FUSED_LOSS_TOL,
                               atol=FUSED_LOSS_TOL)
    for m in result.metrics_history:
        assert 0.0 <= m["pp_bubble_s"] < m["step_s"]


def test_each_rank_gets_its_stage(pipeline_run):
    name, _, contexts, _ = pipeline_run
    _, virtual = CASES[name]
    for rank, ctx in enumerate(contexts):
        assert ctx == {"num_stages": 2, "microbatches": MICRO, "virtual": virtual,
                       "attempt": 0, "stage": rank, "stage_rank": 0}


BAD_CONFIGS = [
    dict(num_workers=2, pipeline_stages=0),
    dict(num_workers=2, pipeline_stages=2, microbatches=0),
    dict(num_workers=2, pipeline_stages=2, microbatches=4, virtual_stages=0),
    dict(num_workers=2, pipeline_stages=2, microbatches=3, virtual_stages=2),
    dict(num_workers=3, pipeline_stages=2, microbatches=4),
]


@pytest.mark.parametrize("kwargs", BAD_CONFIGS, ids=[str(i) for i in range(len(BAD_CONFIGS))])
def test_scaling_config_refuses_as_the_reference(kwargs):
    from ray_tpu.train.config import ScalingConfig as JaxScalingConfig

    errors = []
    for cls in (ScalingConfig, JaxScalingConfig):
        with pytest.raises(ValueError) as err:
            cls(**kwargs)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("workers,stages,micro,virtual",
                         [(2, 2, 4, 1), (4, 2, 8, 2), (4, 4, 4, 1), (1, 1, 1, 1)])
def test_factorization_matches_the_reference(workers, stages, micro, virtual):
    from ray_tpu.train.config import ScalingConfig as JaxScalingConfig

    kwargs = dict(num_workers=workers, pipeline_stages=stages, microbatches=micro,
                  virtual_stages=virtual)
    assert ScalingConfig(**kwargs).factorization() == \
        JaxScalingConfig(**kwargs).factorization()


class _TwoRanks(_wire.Wire):
    size = 2

    def __init__(self, rank):
        self.rank = rank


def _runner(ctx, wire=None):
    cfg = _pp_config(pt, torch.float32)
    params = pt.init_params(cfg, 0, device="cpu")
    return PipelineStageRunner(
        ctx=ctx, stage_fn=lambda p, a: a, last_stage_fn=lambda p, a, m: a.sum(),
        params=pt.partition_stages(params, cfg, 2)[ctx.pipeline["stage"] if ctx.pipeline else 0],
        optimizer=_sgd, activation_like=lambda m: m, microbatch_fn=microbatch_slicer,
        wire=wire)


def test_runner_refusals():
    pipe = {"num_stages": 2, "microbatches": 4, "virtual": 1, "stage": 1, "stage_rank": 0}
    with pytest.raises(ValueError, match="TrainContext.pipeline is unset"):
        _runner(session.TrainContext(world_size=2))
    with pytest.raises(NotImplementedError, match="stage gangs wider than one worker"):
        _runner(session.TrainContext(world_size=4, pipeline=pipe), _TwoRanks(1))
    with pytest.raises(ValueError, match="stage 1 of 2 needs its own"):
        _runner(session.TrainContext(world_size=2, pipeline=pipe), _TwoRanks(0))
    runner = _runner(session.TrainContext(world_size=2, pipeline=pipe), _TwoRanks(1))
    assert runner.schedule == [("F", 0, 0), ("B", 0, 0), ("F", 1, 0), ("B", 1, 0),
                               ("F", 2, 0), ("B", 2, 0), ("F", 3, 0), ("B", 3, 0)]


def test_microbatch_slicer_refuses_an_uneven_batch():
    assert microbatch_slicer({"x": np.arange(8)}, 1, 4)["x"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="not divisible by microbatches=3"):
        microbatch_slicer({"x": np.arange(8)}, 0, 3)


# -------------------------------------------------------------- two cards
@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_trainer_on_two_cards(tmp_path, case):
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA cards, found {torch.cuda.device_count()}")
    n_layers, virtual = CASES[case]
    cfg = _pp_config(pt, torch.float32, n_layers)  # no JAX on the cards' machine
    init = tree_map(lambda t: t.numpy(), pt.init_params(cfg, 0, device="cpu"))
    result, contexts = _fit(tmp_path, case, n_layers, virtual, init, use_gpu=True)
    assert result.error is None, result.error
    losses = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(losses, _port_fused_losses(init, n_layers),
                               rtol=0, atol=TRAJECTORY_LOSS_TOL)
    assert [c["stage"] for c in contexts] == [0, 1]
