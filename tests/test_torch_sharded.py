"""Sharded training of the port against the JAX package's, across processes.

Four spawned ranks on a gloo process group run ``setup_sharded_training``
and ``build_sharded_train_step`` on five meshes; the JAX package runs its
own sharded setup and step on the same mesh shapes over the conftest's
virtual CPU devices, from the same JAX init and batches:

  * ``test_sharding.py``'s ``_tiny_config()``: three SGD(0.1) steps on one
    batch, as its ``_run_sharded`` takes them;
  * ``TransformerConfig.tiny()`` (4 heads over 2 kv heads): two Adam(1e-2)
    steps on fresh batches;
  * an MoE config on {fsdp 2, tp 2}, which the port refuses: expert
    parallelism (MoE on data ranks: ``tests/test_torch_data_ranks.py``).

On a machine with four cards, ``test_sharded_step_on_four_cards`` runs the
same trajectories on NCCL ranks, one a card, against the single-device
step on the first card (no JAX there); elsewhere it skips.

The children get numpy trees and import neither JAX nor the JAX package:
this module imports JAX only inside the fixture. They meet through a
``FileStore`` under the test's temporary directory, run one thread each,
and are killed if they outlast JOIN_TIMEOUT_S.
"""

import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel.mesh import MeshSpec, tree_leaves, tree_map
from ray_tpu_torch.train import torch_utils

WORLD = 4
JOIN_TIMEOUT_S = 120
MESHES = {
    "dp4": {"dp": 4},
    "fsdp4": {"fsdp": 4},
    "dp2_fsdp2": {"dp": 2, "fsdp": 2},
    "fsdp2_tp2": {"fsdp": 2, "tp": 2},
    "dp2_tp2": {"dp": 2, "tp": 2},
}
# tests/test_torch_train.py's bounds: the loss within TRAJECTORY_LOSS_TOL;
# after SGD each gathered leaf within 2e-6 of JAX's (f32 sums in another
# order move the updates' last bits).
TRAJECTORY_LOSS_TOL = 1e-4
SGD_LEAF_TOL = 2e-6
# After Adam each leaf's update (final minus init) within 1e-3 of the
# reference's, by relative Frobenius norm. Adam divides each moment by its
# root mean square, so a gradient element near zero, where the two sides'
# f32 sums in another order differ in their leading bits, becomes a step
# of up to lr in either direction: a few elements of a leaf may differ by
# 2 lr, so no max-abs bound holds, while the update as a whole stays within
# f32 sums. Measured: at most 1.9e-5 against JAX over the five meshes,
# 1.1e-4 for four gloo ranks and 1.9e-4 for four NCCL ranks on H100s
# against one unsharded rank (tp meshes). A
# gradient taken from the wrong kv heads or a wrong shard moves the update
# by order 1; Adam is blind to a gradient's scale, so the SGD case holds
# the scale.
ADAM_UPDATE_TOL = 1e-3
SGD_STEPS, ADAM_STEPS = 3, 2


def _sgd_config(module, dtype):
    """``tests/test_sharding.py``'s ``_tiny_config()``, of either package."""
    return module.TransformerConfig(
        vocab_size=64, dim=16, n_layers=2, n_heads=2, n_kv_heads=2, hidden_dim=32,
        max_seq=16, dtype=dtype,
    )


def _batches():
    rng = np.random.default_rng(3)
    sgd = {"x": rng.integers(0, 64, (8, 16)).astype(np.int32),
           "y": rng.integers(0, 64, (8, 16)).astype(np.int32)}
    rng = np.random.default_rng(5)
    adam = [rng.integers(0, 256, (8, 33)).astype(np.int32) for _ in range(ADAM_STEPS)]
    return sgd, adam


# ------------------------------------------------------------- child side
def _init_fn(tree):
    """init_fn(device) for setup_sharded_training from a numpy tree."""
    def init(device):
        if device == "meta":
            return tree_map(lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta"),
                            tree)
        return params_from_numpy(tree, device=device)
    return init


def _optimizer(kind):
    def make(params):
        leaves = [leaf.requires_grad_(True) for _, leaf in tree_leaves(params)]
        if kind == "sgd":
            return torch.optim.SGD(leaves, lr=0.1)
        return torch.optim.Adam(leaves, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    return make


def _loss(config, kind):
    if kind == "sgd":
        def loss(params, batch):
            return pt.loss_fn(params, batch["x"], batch["y"], config)
    else:
        def loss(params, tok):
            return pt.loss_fn(params, tok[:, :-1], tok[:, 1:], config)
    return loss


def _trajectory(config, init_tree, kind, axes, batches, device="cpu"):
    setup = torch_utils.setup_sharded_training(
        _init_fn(init_tree), _optimizer(kind), mesh=MeshSpec(axes).build(device),
        logical_dims=pt.param_logical_dims(config))
    loss = _loss(config, kind)
    step = torch_utils.build_sharded_train_step(loss, setup)
    params, opt_state, losses = setup.params, setup.opt_state, []
    for batch in batches:
        params, opt_state, value = step(params, opt_state,
                                        setup.shard_batch(tree_map(torch.from_numpy, batch)))
        losses.append(float(value))
    full = {"/".join(path): leaf.full_tensor().detach().cpu().numpy()
            for path, leaf in tree_leaves(params)}
    specs = {"/".join(path): s.spec for path, s in tree_leaves(setup.param_shardings)}
    return {"losses": losses, "params": full, "specs": specs}


def _moe_refusal():
    config = pt.TransformerConfig.tiny(moe=pt.MoEConfig(num_experts=4, top_k=2))
    setup = torch_utils.setup_sharded_training(
        lambda d: pt.init_params(config, 0, d), _optimizer("adam"),
        mesh=MeshSpec({"fsdp": 2, "tp": 2}).build("cpu"),
        logical_dims=pt.param_logical_dims(config))
    step = torch_utils.build_sharded_train_step(
        lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], config), setup)
    tokens = torch.zeros(4, 9, dtype=torch.int64)
    try:
        step(setup.params, setup.opt_state, tokens)
    except NotImplementedError as err:
        return {"raised": "NotImplementedError", "message": str(err)}
    return {"raised": None}


def _worker(rank, store, out_dir, init_trees, batches):
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=WORLD)
        sgd_batch, adam_batches = batches
        results = {}
        for name, axes in MESHES.items():
            results[("sgd", name)] = _trajectory(_sgd_config(pt, torch.float32),
                                                 init_trees["sgd"], "sgd", axes,
                                                 [sgd_batch] * SGD_STEPS)
            results[("adam", name)] = _trajectory(pt.TransformerConfig.tiny(),
                                                  init_trees["adam"], "adam", axes, adam_batches)
        results["moe"] = _moe_refusal()
        if rank == 0:
            with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ------------------------------------------------------------ parent side
def _jax_trajectory(config, kind, axes, batches, devices):
    import jax
    import optax

    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.train import jax_utils

    opt = optax.sgd(0.1) if kind == "sgd" else optax.adam(1e-2)
    setup = jax_utils.setup_sharded_training(
        lambda: jt.init_params(config, jax.random.PRNGKey(0)), opt,
        mesh=JaxMeshSpec(axes).build(devices), logical_dims=jt.param_logical_dims(config))
    if kind == "sgd":
        def loss(params, batch):
            return jt.loss_fn(params, batch["x"], batch["y"], config)
    else:
        def loss(params, tok):
            return jt.loss_fn(params, tok[:, :-1], tok[:, 1:], config)
    step = jax_utils.build_sharded_train_step(loss, opt, setup)
    params, opt_state = setup.params, setup.opt_state
    init = jax.tree.map(np.asarray, params)
    losses = []
    for batch in batches:
        params, opt_state, value = step(params, opt_state, setup.shard_batch(batch))
        losses.append(float(value))
    specs = {"/".join(k.key for k in path): tuple(s.spec) for path, s in
             jax.tree_util.tree_flatten_with_path(setup.param_shardings)[0]}
    full = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    return {"losses": losses, "params": full, "specs": specs, "init": init}


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory, cpu_mesh_devices):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jt

    # The JAX setup's init (sharding-invariant, as it sets it) is what the
    # ranks are given.
    jax.config.update("jax_threefry_partitionable", True)
    out_dir = tmp_path_factory.mktemp("sharded")
    configs = {"sgd": _sgd_config(jt, jnp.float32), "adam": jt.TransformerConfig.tiny()}
    init_trees = {kind: jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(
        c, jax.random.PRNGKey(0))) for kind, c in configs.items()}
    sgd_batch, adam_batches = _batches()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(rank, str(out_dir / "store"), str(out_dir),
                                               init_trees, (sgd_batch, adam_batches)))
             for rank in range(WORLD)]
    start = time.monotonic()
    for p in procs:
        p.start()
    try:
        # The reference runs while the ranks start and train.
        jax_results = {}
        for name, axes in MESHES.items():
            jax_results[("sgd", name)] = _jax_trajectory(
                configs["sgd"], "sgd", axes, [sgd_batch] * SGD_STEPS, cpu_mesh_devices)
            jax_results[("adam", name)] = _jax_trajectory(
                configs["adam"], "adam", axes, adam_batches, cpu_mesh_devices)
        for p in procs:
            p.join(max(1.0, JOIN_TIMEOUT_S - (time.monotonic() - start)))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    errors = [(out_dir / f"error{r}.txt").read_text() for r in range(WORLD)
              if (out_dir / f"error{r}.txt").exists()]
    assert not alive, f"{len(alive)} ranks outlasted {JOIN_TIMEOUT_S} s and were killed"
    assert not errors and all(p.exitcode == 0 for p in procs), "\n".join(errors)
    with open(out_dir / "results.pkl", "rb") as f:
        port_results = pickle.load(f)
    return port_results, jax_results, init_trees


def _leaf_error(kind, got, want, init):
    """SGD: max |got - want|; Adam: the updates' relative Frobenius error."""
    if kind == "sgd":
        return float(np.max(np.abs(got - want)))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want - init), 1e-30))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_sharded_trajectory_matches_jax(trajectories, kind, mesh):
    port_results, jax_results, init_trees = trajectories
    port, ref = port_results[(kind, mesh)], jax_results[(kind, mesh)]
    # Both sides started from the init the ranks were given.
    for path, leaf in tree_leaves(init_trees[kind]):
        ref_init = ref["init"]
        for key in path:
            ref_init = ref_init[key]
        np.testing.assert_array_equal(ref_init, leaf)
    # The same per-leaf placement policy on both sides.
    assert port["specs"] == ref["specs"]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=0, atol=TRAJECTORY_LOSS_TOL)
    if kind == "sgd":  # steps on one batch: the loss falls
        assert port["losses"][-1] < port["losses"][0]
    assert port["params"].keys() == ref["params"].keys()
    init = dict(("/".join(path), leaf) for path, leaf in tree_leaves(init_trees[kind]))
    for name, got in port["params"].items():
        err = _leaf_error(kind, got, ref["params"][name], init[name])
        assert err < (SGD_LEAF_TOL if kind == "sgd" else ADAM_UPDATE_TOL), (name, err)


def test_moe_on_data_ranks_is_refused(trajectories):
    # MoE on data ranks trains (tests/test_torch_data_ranks.py); beside tp
    # it is refused, since the experts would be split across ranks: expert
    # parallelism.
    port_results, _, _ = trajectories
    moe = port_results["moe"]
    assert moe["raised"] == "NotImplementedError"
    assert "ROADMAP Queue A item 4b" in moe["message"]


# ------------------------------------------------------------ four cards
# On the cards each leaf's update is held by its relative Frobenius error
# (``_leaf_error``'s Adam measure): the sharded and the single-card steps
# sum in other orders (tp's split products, the data axes' partial
# gradients, the embedding's scattered rows), each f32 sum off by its
# terms' rounding; a gradient taken twice, or not at all, is off by order
# 1. SGD: bound 1e-4; measured at most 2.0e-5 (the tp meshes; 3.6e-6
# without tp) on four H100s, 7.8e-6 for four gloo ranks.
CARD_SGD_UPDATE_TOL = 1e-4
CARD_MESHES = {
    "dp4": {"dp": 4},
    "fsdp4": {"fsdp": 4},
    "dp2_tp2": {"dp": 2, "tp": 2},
    "fsdp2_tp2": {"fsdp": 2, "tp": 2},
}


def _card_worker(rank, store, out_dir, init_trees, batches):
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=WORLD)
        sgd_batch, adam_batches = batches
        results = {}
        for name, axes in CARD_MESHES.items():
            results[("sgd", name)] = _trajectory(_sgd_config(pt, torch.float32),
                                                 init_trees["sgd"], "sgd", axes,
                                                 [sgd_batch] * SGD_STEPS, "cuda")
            results[("adam", name)] = _trajectory(pt.TransformerConfig.tiny(),
                                                  init_trees["adam"], "adam", axes,
                                                  adam_batches, "cuda")
        if rank == 0:
            with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _single_card(config, init_tree, kind, batches):
    """The same steps on one card, unsharded."""
    params = params_from_numpy(init_tree, device="cuda")
    optimizer = _optimizer(kind)(params)
    loss_fn, losses = _loss(config, kind), []
    for batch in batches:
        loss = loss_fn(params, tree_map(lambda a: torch.from_numpy(a).cuda(), batch))
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    return {"losses": losses, "params": {"/".join(path): leaf.detach().cpu().numpy()
                                         for path, leaf in tree_leaves(params)}}


@pytest.mark.cuda
def test_sharded_step_on_four_cards(tmp_path):
    """NCCL ranks, one a card, on four meshes against the single-device
    steps on the first card, within the CPU test's bounds: tp re-associates
    sums and the data axes sum partial gradients, as GSPMD does."""
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards, found {torch.cuda.device_count()}")
    from ray_tpu_torch import _build

    _build.library()  # built once here, loaded by every rank
    configs = {"sgd": _sgd_config(pt, torch.float32), "adam": pt.TransformerConfig.tiny()}
    init_trees = {kind: tree_map(lambda t: t.numpy(), pt.init_params(c, 0, "cpu"))
                  for kind, c in configs.items()}
    sgd_batch, adam_batches = _batches()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_card_worker, args=(rank, str(tmp_path / "store"), str(tmp_path),
                                                    init_trees, (sgd_batch, adam_batches)))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    refs = {kind: _single_card(configs[kind], init_trees[kind], kind,
                               [sgd_batch] * SGD_STEPS if kind == "sgd" else adam_batches)
            for kind in configs}
    start = time.monotonic()
    for p in procs:
        p.join(max(1.0, JOIN_TIMEOUT_S - (time.monotonic() - start)))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = [(tmp_path / f"error{r}.txt").read_text() for r in range(WORLD)
              if (tmp_path / f"error{r}.txt").exists()]
    assert not alive and not errors and all(p.exitcode == 0 for p in procs), "\n".join(errors)
    with open(tmp_path / "results.pkl", "rb") as f:
        results = pickle.load(f)
    loss_errs, update_errs = {}, {}
    for (kind, mesh), got in results.items():
        ref = refs[kind]
        loss_errs[kind, mesh] = float(np.max(np.abs(np.subtract(got["losses"], ref["losses"]))))
        init = dict(("/".join(path), leaf) for path, leaf in tree_leaves(init_trees[kind]))
        update_errs[kind, mesh] = max(
            _leaf_error("adam", leaf, ref["params"][name], init[name])
            for name, leaf in got["params"].items())
    report = f"loss errors {loss_errs}, worst update errors {update_errs}"
    print(report)  # the measurement, with -s
    assert max(loss_errs.values()) < TRAJECTORY_LOSS_TOL, report
    for (kind, mesh), err in update_errs.items():
        assert err < (CARD_SGD_UPDATE_TOL if kind == "sgd" else ADAM_UPDATE_TOL), report
