"""The ring wire under the port's trainer, pipeline and compiled graphs,
against the reference.

* ``TorchTrainer(backend="ring")`` with ``ScalingConfig.collective_config``
  int8 on 2 CPU workers at a tiny transformer: each rank's gradient synced
  by ``train.torch_utils.sync_gradients`` (twice, so the second carries the
  first's error feedback) is bitwise the reference's
  ``jax_utils.sync_gradients`` over its own int8 ring (a reference
  ``WorkerGang``) on the same leaves; and the split train step over an
  int8 or fp8 ring with the overlap keeps the ranks' parameters bitwise
  equal, the fence's exposed time in every step's StepStats.
* A 2-stage pipeline on a ring gang with ``quantize_activations="int8"``
  (the activation and cotangent hand-offs block-scale quantized with a
  residual an edge) lands on the exact wire's loss floor within the
  reference's bar (``tests/test_overlap.py``'s
  ``test_quantized_activation_pipeline_convergence``).
* A compiled graph with ``quantize_wire="int8"`` on device edges carrying
  host float arrays gives, execution after execution, what the
  reference's codec gives for the same hops: encode through each edge's
  error feedback, decode, compute.
"""

import numpy as np
import pytest
import torch

import _torch_dag_apps as apps
from ray_tpu.util.collective.quantization import CollectiveConfig as RefConfig
from ray_tpu.util.collective.quantization import ErrorFeedback as RefErrorFeedback
from ray_tpu.util.collective.quantization import decode as ref_decode
from ray_tpu.util.gang import WorkerGang as RefGang
from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel.mesh import tree_leaves, tree_map
from ray_tpu_torch.train import session
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.stage_runner import PipelineStageRunner, microbatch_slicer
from ray_tpu_torch.train.trainer import TorchTrainer
from ray_tpu_torch.util.collective import CollectiveConfig

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

INT8 = {"quantize": "int8", "block_size": 128}


def _tiny():
    return pt.TransformerConfig.tiny(max_seq=16)


# ------------------------------------------------------------- gradient sync
def _grad_loop(config):
    """One worker: its gradient at the initial parameters on its own batch,
    synced twice over the gang's ring (one report), then two split steps
    over the same ring, the overlap on (a report each, saying whether the
    ranks' parameters, gathered over the ring, are the same bits)."""
    from ray_tpu_torch.train import torch_utils
    from ray_tpu_torch.train.step import make_optimizer, named_leaves
    from ray_tpu_torch.util import collective

    ctx = session.get_context()
    group = collective.get_group(ctx.collective_group)
    cfg = _tiny()
    params = pt.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(40 + ctx.world_rank)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, cfg.max_seq + 1)))
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(params)]
    pt.loss_fn(params, tokens[:, :-1], tokens[:, 1:], cfg).backward()
    grads = [leaf.grad.detach().clone() for leaf in leaves]
    synced = [torch_utils.sync_gradients(grads, ctx.collective_group) for _ in range(2)]
    session.report({"grads": [g.numpy() for g in grads],
                    "synced": [[s.numpy() for s in step] for step in synced],
                    "backend": group.backend_name, "quantize": group.config.quantize})
    setup = torch_utils.setup_sharded_training(
        lambda device: pt.init_params(cfg, 0, device=device), make_optimizer,
        mesh=torch_utils.build_mesh({"dp": 2}, "cpu"))
    step = torch_utils.build_sharded_train_step(
        lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], cfg), setup,
        group_name=ctx.collective_group)
    batch = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg.vocab_size, (4, cfg.max_seq + 1)))
    p, o = setup.params, setup.opt_state
    for _ in range(2):
        p, o, loss = step(p, o, batch)
        flat = torch.cat([leaf.to_local().detach().reshape(-1) for _, leaf in tree_leaves(p)])
        gathered = group.allgather(flat.numpy())
        session.report({"loss": float(loss),
                        "equal": all(g.tobytes() == gathered[0].tobytes() for g in gathered)})


def _ring_fit(tmp_path, kind: str):
    result = TorchTrainer(
        _grad_loop, backend="ring",
        scaling_config=ScalingConfig(
            num_workers=2, use_gpu=False, mesh_axes={"dp": 2},
            collective_config=CollectiveConfig(quantize=kind, block_size=128, overlap=True,
                                               bucket_bytes=4096)),
        run_config=RunConfig(name=f"ring-{kind}", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    return result


def _ref_sync(ctx, leaves_by_rank):
    from ray_tpu.train import jax_utils

    leaves = leaves_by_rank[ctx.rank]
    return [jax_utils.sync_gradients(list(leaves), ctx.group_name) for _ in range(2)]


@pytest.fixture(scope="module")
def grad_run(tmp_path_factory):
    return _ring_fit(tmp_path_factory.mktemp("ring_int8"), "int8")


def test_synced_gradient_is_the_reference_int8_ring(grad_run, ray_start_shared):
    report = grad_run.metrics_history[0]
    assert report["backend"] == "ring" and report["quantize"] == "int8"
    # Rank 0's report carries its own leaves; rank 1's are rebuilt from the
    # same seed in the reference's gang, the way _grad_loop makes them.
    cfg = _tiny()
    leaves_by_rank = []
    for rank in range(2):
        params = pt.init_params(cfg, 0, device="cpu")
        rng = np.random.default_rng(40 + rank)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, cfg.max_seq + 1)))
        from ray_tpu_torch.train.step import named_leaves

        leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(params)]
        pt.loss_fn(params, tokens[:, :-1], tokens[:, 1:], cfg).backward()
        leaves_by_rank.append([leaf.grad.detach().numpy().copy() for leaf in leaves])
    assert all(np.array_equal(a, b) for a, b in zip(report["grads"], leaves_by_rank[0]))
    gang = RefGang(2, backend="ring", collective_config=RefConfig(**INT8))
    try:
        ref = gang.run(_ref_sync, timeout=120, leaves_by_rank=leaves_by_rank)
    finally:
        gang.shutdown()
    for step in range(2):
        for got, want in zip(report["synced"][step], ref[0][step]):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # The ranks decode the same bytes: the reference's ranks agree too.
    assert all(a.tobytes() == b.tobytes() for a, b in zip(ref[0][1], ref[1][1]))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_ranks_parameters_stay_bitwise_equal_on_a_quantized_ring(kind, grad_run, tmp_path):
    result = grad_run if kind == "int8" else _ring_fit(tmp_path, kind)
    steps = result.metrics_history[1:]
    assert [m["equal"] for m in steps] == [True, True]
    assert all(np.isfinite(m["loss"]) for m in steps)
    # The overlap ran: its fence's exposed time is in every rank's StepStats.
    for records in result.step_stats.values():
        assert all(r["comm_exposed_s"] > 0.0 for r in records[1:])


# ---------------------------------------------------------- pipeline activations
def _pp_config(n_layers=2):
    return pt.TransformerConfig(vocab_size=64, dim=16, n_layers=n_layers, n_heads=2,
                                n_kv_heads=2, hidden_dim=32, max_seq=16, dtype=torch.float32)


def _pp_batches(n):
    rng = np.random.default_rng(17)
    return [{"x": rng.integers(0, 64, (8, 16)).astype(np.int32),
             "y": rng.integers(0, 64, (8, 16)).astype(np.int32)} for _ in range(n)]


def _pp_ring_loop(config):
    """One stage of the 2-stage pipeline on the ring gang's wire."""
    ctx = session.get_context()
    cfg = _pp_config()
    stage, stages = ctx.pipeline["stage"], ctx.pipeline["num_stages"]
    params = params_from_numpy(config["init"], device="cpu")
    chunk = pt.partition_stages(params, cfg, stages)[stage]

    def stage_fn(p, a):
        return pt.stage_forward(p, a, cfg, first=(stage == 0), last=False)

    def last_fn(p, a, micro):
        return pt.logits_loss(pt.stage_forward(p, a, cfg, first=False, last=True), micro["y"])

    runner = PipelineStageRunner(
        ctx=ctx, stage_fn=stage_fn, last_stage_fn=last_fn,
        params=tree_map(torch.clone, chunk),
        optimizer=lambda tree: torch.optim.SGD([x for _, x in tree_leaves(tree)], lr=0.1),
        activation_like=lambda micro: torch.empty((*micro["y"].shape, cfg.dim),
                                                  dtype=cfg.dtype, device="meta"),
        microbatch_fn=microbatch_slicer)
    for batch in _pp_batches(config["batches"]):
        session.report({"loss": runner.train_step(batch),
                        "wire": type(runner.wire).__name__,
                        "codec": runner.wire.codec is not None})


def _pipeline_losses(tmp_path, name, init, collective_config):
    result = TorchTrainer(
        _pp_ring_loop, train_loop_config={"init": init, "batches": 6}, backend="ring",
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False, pipeline_stages=2,
                                     microbatches=4, collective_config=collective_config),
        run_config=RunConfig(name=name, storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    return result.metrics_history


def test_quantized_activation_pipeline_converges_as_the_reference_asks(tmp_path):
    init = _jax_init()
    exact = _pipeline_losses(tmp_path, "act-exact", init, None)
    quant = _pipeline_losses(tmp_path, "act-int8", init,
                             CollectiveConfig(quantize_activations="int8", block_size=64))
    assert {(m["wire"], m["codec"]) for m in exact} == {("GroupWire", False)}
    assert {(m["wire"], m["codec"]) for m in quant} == {("GroupWire", True)}
    exact, quant = [m["loss"] for m in exact], [m["loss"] for m in quant]
    assert exact[-1] < exact[0] and quant[-1] < quant[0]
    assert abs(quant[-1] - exact[-1]) <= max(0.02, exact[-1] * 0.5)
    assert max(quant) <= max(exact) * 1.5 + 0.05
    assert quant != exact  # the codec really ran


def _jax_init(n_layers=2) -> dict:
    """The reference test's initial parameters (its JAX init at key 0),
    as numpy: the same start, so the same loss trajectory to bound."""
    import jax

    from ray_tpu.models import transformer as jt

    jax.config.update("jax_threefry_partitionable", True)
    cfg = jt.TransformerConfig(vocab_size=64, dim=16, n_layers=n_layers, n_heads=2,
                               n_kv_heads=2, hidden_dim=32, max_seq=16,
                               dtype=jax.numpy.float32)
    return jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0)))


# ------------------------------------------------------------- compiled graphs
@pytest.fixture(scope="module")
def port_runtime():
    yield
    local_tasks.shutdown()


def test_quantize_wire_equals_the_reference_codec_hop_by_hop(port_runtime):
    a = local_tasks.remote(apps.Stage).remote(1)
    b = local_tasks.remote(apps.Stage).remote(2)
    with InputNode() as inp:
        out = b.add.bind(a.add.bind(inp))
    dag = out.experimental_compile(channel="device", quantize_wire="int8")
    rng = np.random.default_rng(23)
    inputs = [(rng.standard_normal((3, 50)) * 10.0 ** (k - 2)).astype(np.float32)
              for k in range(4)]
    try:
        got = [dag.execute(x).get(timeout=60) for x in inputs]
        ints = dag.execute(np.arange(6, dtype=np.int64)).get(timeout=60)
    finally:
        dag.close()
    cfg = RefConfig(quantize_activations="int8").activation_wire_config()
    # One residual an edge: driver -> a, a -> b, b -> driver.
    edges = [RefErrorFeedback() for _ in range(3)]

    def hop(ef, x):
        enc = ef.encode(("edge",), x.ravel(), cfg)
        return ref_decode(enc).reshape(x.shape).astype(x.dtype)

    for x, y in zip(inputs, got):
        want = hop(edges[2], hop(edges[1], hop(edges[0], x) + 1) + 2)
        assert y.dtype == want.dtype and y.tobytes() == want.tobytes()
    # Non-float payloads stay exact.
    assert ints.tolist() == [3, 4, 5, 6, 7, 8]
