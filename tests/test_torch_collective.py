"""The port's collective group (``ray_tpu_torch.util.collective.NcclGroup``)
against the reference's semantics (``ray_tpu/util/collective/collective.py``,
``XlaGroup``), computed here with numpy.

Four spawned ranks form a gloo group and run every op on numpy arrays and
on tensors: allreduce (SUM, PRODUCT, MIN, MAX, bf16 PRODUCT), allgather,
broadcast, an uneven reducescatter (``np.array_split`` chunks of 3, 3, 2
and 2), barrier, paired p2p with bystanders, and send / recv; then the
gradient syncs of ``train.torch_utils`` through the group, and the split
step (``build_sharded_train_step(group_name=...)``) against the fused one.
One process holds the one-rank semantics (each op returns its input). On a machine
with four cards, ``test_collectives_on_four_cards`` runs the same ops on
NCCL ranks, one a card; elsewhere it skips.
"""

import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

from ray_tpu_torch.util import collective

WORLD = 4
JOIN_TIMEOUT_S = 120
OPS = ("sum", "product", "min", "max")


def _inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return {"x": rng.standard_normal((2, 5)).astype(np.float32) + 2.0,
            "uneven": rng.standard_normal(10).astype(np.float32),
            "ints": rng.integers(-5, 5, (3,)).astype(np.int64),
            "bf16": (rng.random(6).astype(np.float32) + 0.5)}


def _ops(rank, backend, device):
    """Every op of the group on this rank's inputs; numpy in, numpy out,
    and the same on tensors."""
    group = collective.get_group("g")
    x = _inputs(rank)
    out = {}
    for op in OPS:
        out[("allreduce", op)] = group.allreduce(x["x"], op=op)
        out[("reducescatter", op)] = group.reducescatter(x["uneven"], op=op)
    out["allreduce_ints"] = collective.allreduce(x["ints"], "g")
    reduced = group.allreduce(torch.from_numpy(x["x"]).to(device))
    out["types"] = [type(out[("allreduce", "sum")]).__name__, type(reduced).__name__]
    out["allreduce_tensor"] = reduced.cpu().numpy()
    bf16 = torch.from_numpy(x["bf16"]).to(torch.bfloat16).to(device)
    out["product_bf16"] = group.allreduce(bf16, op="product").float().cpu().numpy()
    out["allgather"] = collective.allgather(x["x"], "g")
    out["broadcast"] = collective.broadcast(x["x"], src_rank=2, group_name="g")
    collective.barrier("g")
    out["p2p"] = group.p2p(x["x"] if rank == 1 else np.zeros_like(x["x"]), 1, 3)
    if rank == 0:
        group.send(x["ints"], 2)
    elif rank == 2:
        out["recv"] = group.recv(0, like=np.zeros(3, np.int64))
    return out


def _grad_syncs(rank, device):
    """The gradient syncs of ``train.torch_utils`` through group "g", and
    the split step against the fused one on {dp 4} from one init."""
    from ray_tpu_torch.models import transformer as pt
    from ray_tpu_torch.parallel.mesh import MeshSpec, tree_leaves
    from ray_tpu_torch.train import torch_utils
    from ray_tpu_torch.train.step import make_optimizer

    rng = np.random.default_rng(7 + rank)
    grads = {"a": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)).to(device),
             "b": {"c": torch.from_numpy(rng.standard_normal(5).astype(np.float32)).to(device)}}
    out = {"grads": {k: v.cpu().numpy() for k, v in (("a", grads["a"]), ("c", grads["b"]["c"]))}}
    synced = torch_utils.sync_gradients(grads, "g")
    out["sync"] = {"a": synced["a"].cpu().numpy(), "c": synced["b"]["c"].cpu().numpy()}
    handle = torch_utils.begin_gradient_sync(grads, "g", bucket_bytes=16)
    overlapped = handle.result()
    out["overlap"] = {"a": overlapped["a"].cpu().numpy(), "c": overlapped["b"]["c"].cpu().numpy()}
    out["overlap_stats"] = dict(handle.stats)
    out["sharded"] = [torch_utils.sync_gradients_sharded(
        grads, "g", overlap=overlap, bucket_bytes=16)["a"].cpu().numpy()
        for overlap in (False, True)]
    out["psum"] = torch_utils.grad_psum(grads["a"]).cpu().numpy()

    config = pt.TransformerConfig.tiny()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (8, 17)))
    runs = {}
    for name, group_name in (("fused", None), ("split", "g")):
        setup = torch_utils.setup_sharded_training(
            lambda d: pt.init_params(config, 0, d), make_optimizer,
            mesh=MeshSpec({"dp": WORLD}).build(device.split(":")[0]),
            logical_dims=pt.param_logical_dims(config))
        step = torch_utils.build_sharded_train_step(
            lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], config), setup,
            group_name=group_name)
        params, opt, loss = step(setup.params, setup.opt_state, tokens)
        runs[name] = {"loss": float(loss), "stats": dict(getattr(step, "stats", {})),
                      "params": {"/".join(p): leaf.full_tensor().detach().cpu().numpy().copy()
                                 for p, leaf in tree_leaves(params)}}
    out["steps"] = runs
    return out


def _worker(rank, store, out_dir, backend):
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        device = "cpu"
        if backend == "nccl":
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=WORLD)
        collective.init_collective_group(WORLD, rank, backend=backend, group_name="g")
        out = _ops(rank, backend, device)
        out["syncs"] = _grad_syncs(rank, device)
        collective.destroy_collective_group("g")
        with open(os.path.join(out_dir, f"ops{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _run_ranks(tmp_path, backend):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(rank, str(tmp_path / "store"), str(tmp_path),
                                               backend)) for rank in range(WORLD)]
    start = time.monotonic()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, JOIN_TIMEOUT_S - (time.monotonic() - start)))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = [(tmp_path / f"error{r}.txt").read_text() for r in range(WORLD)
              if (tmp_path / f"error{r}.txt").exists()]
    assert not alive, f"{len(alive)} ranks outlasted {JOIN_TIMEOUT_S} s and were killed"
    assert not errors and all(p.exitcode == 0 for p in procs), "\n".join(errors)
    results = []
    for rank in range(WORLD):
        with open(tmp_path / f"ops{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("collective"), "gloo")


_REDUCE = {"sum": np.sum, "product": np.prod, "min": np.min, "max": np.max}


def _check_ops(results, rtol):
    inputs = [_inputs(r) for r in range(WORLD)]
    stacked = np.stack([x["x"] for x in inputs])
    for rank, out in enumerate(results):
        assert out["types"] == ["ndarray", "Tensor"]
        for op in OPS:
            want = _REDUCE[op](stacked, axis=0)
            np.testing.assert_allclose(out[("allreduce", op)], want, rtol=rtol)
            # The reference: np.array_split(reduced.reshape(-1), world)[rank].
            reduced = _REDUCE[op](np.stack([x["uneven"] for x in inputs]), axis=0)
            chunk = np.array_split(reduced.reshape(-1), WORLD)[rank]
            assert out[("reducescatter", op)].shape == chunk.shape == ((3,) if rank < 2 else (2,))
            np.testing.assert_allclose(out[("reducescatter", op)], chunk, rtol=rtol)
        np.testing.assert_array_equal(out["allreduce_ints"],
                                      np.sum([x["ints"] for x in inputs], axis=0))
        np.testing.assert_allclose(out["allreduce_tensor"], stacked.sum(0), rtol=rtol)
        # bf16 product: taken in f32, rounded once to bf16.
        want = torch.from_numpy(np.prod(np.stack(
            [torch.from_numpy(x["bf16"]).to(torch.bfloat16).float().numpy() for x in inputs]),
            axis=0)).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(out["product_bf16"], want)
        assert len(out["allgather"]) == WORLD
        for got, x in zip(out["allgather"], inputs):
            np.testing.assert_array_equal(got, x["x"])
        np.testing.assert_array_equal(out["broadcast"], inputs[2]["x"])
        if rank == 3:
            np.testing.assert_array_equal(out["p2p"], inputs[1]["x"])
        else:
            assert out["p2p"] is None
    np.testing.assert_array_equal(results[2]["recv"], inputs[0]["ints"])


def test_every_op_matches_the_reference_semantics(gloo_ranks):
    # f32 sums of four terms in another order than numpy's.
    _check_ops(gloo_ranks, rtol=1e-6)


def _check_syncs(results):
    grads = [r["syncs"]["grads"] for r in results]
    split_mean = float(np.mean([r["syncs"]["steps"]["split"]["loss"] for r in results]))
    mean = {k: np.mean([g[k] for g in grads], axis=0) for k in ("a", "c")}
    for out in (r["syncs"] for r in results):
        for k in ("a", "c"):
            np.testing.assert_allclose(out["sync"][k], mean[k], rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(out["overlap"][k], mean[k], rtol=1e-6, atol=1e-7)
        # 16 bytes a bucket: the leaves' 17 f32 fill two buckets, last leaf first.
        assert out["overlap_stats"]["buckets"] == 2 and out["overlap_stats"]["comm_exposed_s"] >= 0
        for sharded in out["sharded"]:
            np.testing.assert_allclose(sharded, mean["a"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["psum"], mean["a"] * WORLD, rtol=1e-6, atol=1e-6)
        fused, split = out["steps"]["fused"], out["steps"]["split"]
        # One step of AdamW from one init: the split step syncs the same
        # gradients through the group that DTensor reduces in the fused one,
        # and returns each worker's own loss, whose mean is the fused one's.
        assert abs(fused["loss"] - split_mean) < 1e-6
        assert set(split["stats"]) == {"fwd_s", "bwd_s", "grad_sync_s", "opt_s"}
        for name, value in fused["params"].items():
            np.testing.assert_allclose(split["params"][name], value, rtol=0, atol=1e-6)


def test_gradient_syncs_and_the_split_step(gloo_ranks):
    _check_syncs(gloo_ranks)


def test_one_rank_group_returns_its_input(tmp_path):
    """World size 1: every op returns its input, as the reference's
    ``XlaGroup`` does; reducescatter its flattened input."""
    import torch.distributed as dist

    before = dist.is_initialized()
    collective.init_collective_group(1, 0, backend="gloo", group_name="one")
    try:
        group = collective.get_group("one")
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        t = torch.arange(4.0)
        assert group.allreduce(x, op="max") is not None
        np.testing.assert_array_equal(group.allreduce(x, op="product"), x)
        assert group.allreduce(t) is t
        np.testing.assert_array_equal(group.allgather(x)[0], x)
        np.testing.assert_array_equal(group.broadcast(x), x)
        np.testing.assert_array_equal(group.reducescatter(x), x.reshape(-1))
        group.barrier()
        with pytest.raises(ValueError, match="local copy"):
            group.p2p(x, 0, 0)
        with pytest.raises(ValueError, match="like="):
            group.recv(0)
        with pytest.raises(ValueError, match="none of"):
            group.allreduce(x, op="mean")
        with pytest.raises(ValueError, match="already initialized"):
            collective.init_collective_group(1, 0, backend="gloo", group_name="one")
    finally:
        collective.destroy_collective_group("one")
    # The group ends the process group it started, and only that one.
    assert dist.is_initialized() == before
    with pytest.raises(ValueError, match="not initialized"):
        collective.get_group("one")


@pytest.mark.parametrize("backend", ["ring", "hier", "xla"])
def test_other_backends_are_refused(backend):
    """"ring" and "xla" are not ported. "hier" is (HierarchicalGroup,
    tests/test_torch_topology.py); with no process group up its tier 2 asks
    for NCCL, which refuses to start without a card, as "nccl" does."""
    if backend == "hier":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the NCCL tier can start")
        with pytest.raises(RuntimeError, match="CUDA device"):
            collective.init_collective_group(1, 0, backend=backend, group_name="refused")
        assert "refused" not in collective._groups
        return
    with pytest.raises(ValueError, match="not ported"):
        collective.init_collective_group(1, 0, backend=backend, group_name="refused")


def test_nccl_group_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        collective.init_collective_group(1, 0, backend="nccl", group_name="nccl")


@pytest.mark.cuda
def test_collectives_on_four_cards(tmp_path):
    """The same ops on NCCL ranks, one a card."""
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards, found {torch.cuda.device_count()}")
    results = _run_ranks(tmp_path, "nccl")
    _check_ops(results, rtol=1e-6)
    _check_syncs(results)
