"""MoE routing and the masked loss of the port's sharded step across data
ranks, against the JAX package's sharded step (GSPMD over the global
batch) on the conftest's virtual CPU devices.

Spawned gloo ranks, four and two, each take one SGD(1.0) step (a leaf's
update is minus its gradient) from the JAX init:

  * ``MOE_CONFIG`` (tiny() with 4 experts, top-2, capacity factor 0.5, so
    that choices are dropped) on {dp 4}, {fsdp 4}, {dp 2, fsdp 2}, {dp 2}
    and {fsdp 2}: every rank's dispatch, stacked in the data ranks' order,
    equals JAX's ``_moe_mlp`` on the global tokens exactly; the loss and
    gradients match JAX's sharded step;
  * the masked loss with masks whose counts differ across ranks (the last
    rank's all zero) on {dp 2, fsdp 2}, {fsdp 4} and {dp 2}: the loss and
    gradients of the global masked mean, which the mean of the ranks' own
    masked means is not; the same with a regulariser of the params added
    to it, which keeps its own gradient.

The split form (``build_sharded_train_step(group_name=...)``) takes three
AdamW steps on {dp 4} and {dp 2} from the same init, with the masked loss
and with MoE, against the reference's split form: JAX's
``build_sharded_train_step(group_name=...)`` run by one thread a worker,
each on a private one-device mesh, whose gradients meet through a
thread-backed group registered in the reference's collective registry.
Each worker's losses and the final params match.

The children get numpy trees and import neither JAX nor the JAX package:
this module imports JAX only inside the fixture and the tests. They meet
through a ``FileStore`` under the test's temporary directory, run one
thread each, and are killed if they outlast JOIN_TIMEOUT_S.
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

JOIN_TIMEOUT_S = 180
# One SGD(1.0) step: each leaf's update is held to the f32 gradient bound
# of tests/test_ops.py, the loss to the f32 forward bound.
GRAD_TOL = 2e-4
F32_TOL = 2e-5
# Meshes, by world size.
MOE_MESHES = {4: {"dp4": {"dp": 4}, "fsdp4": {"fsdp": 4}, "dp2_fsdp2": {"dp": 2, "fsdp": 2}},
              2: {"dp2": {"dp": 2}, "fsdp2": {"fsdp": 2}}}
MASK_MESHES = {4: {"dp2_fsdp2": {"dp": 2, "fsdp": 2}, "fsdp4": {"fsdp": 4}},
               2: {"dp2": {"dp": 2}}}
# The regulariser's weight: its gradient, 2 * REG_WEIGHT on each final-norm
# weight, is 100 times GRAD_TOL.
REG_WEIGHT = 1e-2
# The split form's AdamW steps, and the bound on the params after them
# (tests/test_torch_checkpoint.py's).
SPLIT_STEPS = 3
STEP_TOL = 2e-4
SPLIT_LOSSES = ("masked", "moe")


def _moe_config(module):
    """tiny() with 4 experts, top-2 and room for half of the choices."""
    return module.TransformerConfig.tiny(
        moe=module.MoEConfig(num_experts=4, top_k=2, capacity_factor=0.5))


def _routing_batches():
    """The MoE case's tokens, and the masked case's tokens and mask: the
    mask's count differs on every pair of rows, and rows 6 and 7 (the last
    rank's on four data ranks) have none."""
    rng = np.random.default_rng(9)
    moe = rng.integers(0, 256, (8, 17)).astype(np.int32)
    tok = rng.integers(0, 256, (8, 17)).astype(np.int32)
    keep = np.array([0.9, 0.8, 0.5, 0.4, 0.2, 0.1, 0.0, 0.0])[:, None]
    mask = (rng.random((8, 16)) < keep).astype(np.float32)
    return moe, {"tok": tok, "mask": mask}


# ------------------------------------------------------------- child side
def _init_fn(tree):
    """init_fn(device) for setup_sharded_training from a numpy tree."""
    def init(device):
        if device == "meta":
            return tree_map(lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta"),
                            tree)
        return params_from_numpy(tree, device=device)
    return init


def _one_step(config, init_tree, axes, batch, loss):
    """One SGD(1.0) step on ``batch``: the loss and the gathered params."""
    setup = torch_utils.setup_sharded_training(
        _init_fn(init_tree), lambda p: torch.optim.SGD(
            [leaf.requires_grad_(True) for _, leaf in tree_leaves(p)], lr=1.0),
        mesh=MeshSpec(axes).build("cpu"), logical_dims=pt.param_logical_dims(config))
    step = torch_utils.build_sharded_train_step(loss, setup)
    params, _, value = step(setup.params, setup.opt_state,
                            setup.shard_batch(tree_map(torch.from_numpy, batch)))
    full = {"/".join(path): leaf.full_tensor().detach().numpy()
            for path, leaf in tree_leaves(params)}
    return {"loss": float(value), "params": full}


def _routing_cases(world, init_trees, moe_tokens, masked):
    """The MoE and masked-loss cases of this world size; every rank returns
    its routing (the local tokens and the combine tensor of each MoE layer
    in forward order)."""
    results = {}
    moe_config = _moe_config(pt)
    original = pt._moe_combine
    for name, axes in MOE_MESHES[world].items():
        routing = []

        def spy(ht, router, moe, ctx=None):
            combine = original(ht, router, moe, ctx)
            routing.append((ht.detach().numpy().copy(), combine.detach().numpy().copy()))
            return combine

        pt._moe_combine = spy
        try:
            results[("moe", name)] = _one_step(
                moe_config, init_trees["moe"], axes, moe_tokens,
                lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], moe_config))
        finally:
            pt._moe_combine = original
        results[("moe", name)]["routing"] = routing
    config = pt.TransformerConfig.tiny()
    for name, axes in MASK_MESHES[world].items():
        results[("masked", name)] = _one_step(config, init_trees["dense"], axes, masked,
                                              _masked_loss(pt, config))
        results[("regularised", name)] = _one_step(
            config, init_trees["dense"], axes, masked,
            _masked_loss(pt, config, lambda w: (w.float() ** 2).sum()))
    return results


def _masked_loss(module, config, square_sum=None):
    """The masked loss of ``module``'s transformer, plus REG_WEIGHT times
    ``square_sum`` of the final norm's weight when it is given."""
    def loss(p, b):
        value = module.loss_fn(p, b["tok"][:, :-1], b["tok"][:, 1:], config, b["mask"])
        return value if square_sum is None else value + REG_WEIGHT * square_sum(p["final_norm"])
    return loss


def _split_losses(module):
    """(config, init tree key, loss_fn over the batch, batch index) of each
    split-form case, for ``module``'s transformer."""
    dense, moe = module.TransformerConfig.tiny(), _moe_config(module)
    return {"masked": (dense, "dense", _masked_loss(module, dense), 1),
            "moe": (moe, "moe", lambda p, tok: module.loss_fn(p, tok[:, :-1], tok[:, 1:], moe),
                    0)}


def _split_cases(world, rank, init_trees, batches):
    """SPLIT_STEPS AdamW steps of the split form over group "g" on {dp
    world}: this worker's loss at each step, and the params after them."""
    from ray_tpu_torch.train.step import make_optimizer
    from ray_tpu_torch.util import collective

    collective.init_collective_group(world, rank, backend="gloo", group_name="g")
    results = {}
    try:
        for kind, (config, tree, loss, index) in _split_losses(pt).items():
            setup = torch_utils.setup_sharded_training(
                _init_fn(init_trees[tree]), make_optimizer,
                mesh=MeshSpec({"dp": world}).build("cpu"),
                logical_dims=pt.param_logical_dims(config))
            step = torch_utils.build_sharded_train_step(loss, setup, group_name="g")
            params, opt, losses = setup.params, setup.opt_state, []
            batch = tree_map(torch.from_numpy, batches[index])
            for _ in range(SPLIT_STEPS):
                params, opt, value = step(params, opt, batch)
                losses.append(float(value))
            results[("split", kind)] = {"losses": losses, "params": {
                "/".join(path): leaf.full_tensor().detach().numpy()
                for path, leaf in tree_leaves(params)}}
    finally:
        collective.destroy_collective_group("g")
    return results


def _worker(rank, world, store, out_dir, init_trees, batches):
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        results = _routing_cases(world, init_trees, *batches)
        split = _split_cases(world, rank, init_trees, batches)
        results.update({key + (world, rank): value for key, value in split.items()})
        with open(os.path.join(out_dir, f"results{world}_{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error{world}_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ------------------------------------------------------------ parent side
def _jax_one_step(config, axes, batch, loss, devices):
    """JAX's sharded step with optax.sgd(1.0) on ``batch``: loss and params."""
    import jax
    import optax

    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.train import jax_utils

    opt = optax.sgd(1.0)
    setup = jax_utils.setup_sharded_training(
        lambda: jt.init_params(config, jax.random.PRNGKey(0)), opt,
        mesh=JaxMeshSpec(axes).build(devices), logical_dims=jt.param_logical_dims(config))
    step = jax_utils.build_sharded_train_step(loss, opt, setup)
    params, _, value = step(setup.params, setup.opt_state, setup.shard_batch(batch))
    full = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    return {"loss": float(value), "params": full}


def _jax_split_steps(world, batches, devices):
    """The reference's split form on ``world`` workers, one thread each,
    for every case of ``_split_losses``: {("split", kind, world, rank):
    {"losses", "params"}}. Each worker steps JAX's
    ``build_sharded_train_step(group_name=...)`` with optax.adamw(3e-4) on
    a private mesh of the first device and its rows of the batch; the gradients
    meet in a group of the reference's registry whose allreduce sums the
    workers' arrays in rank order."""
    import threading

    import jax
    import optax

    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.train import jax_utils
    from ray_tpu.util.collective import collective as jax_collective

    barrier = threading.Barrier(world, timeout=JOIN_TIMEOUT_S)
    slots = [None] * world

    class ThreadGroup:
        """What the reference's sync_gradients reads of a group."""

        def __init__(self, rank):
            self.rank, self.world_size = rank, world

        def allreduce(self, x):
            slots[self.rank] = np.asarray(x)
            barrier.wait()
            out = np.sum(np.stack(slots), axis=0)
            barrier.wait()
            return out

    results, errors = {}, []

    def worker(rank):
        name = f"split{world}_{rank}"
        jax_collective._groups[name] = ThreadGroup(rank)
        try:
            for kind, (config, _, loss, index) in _split_losses(jt).items():
                opt = optax.adamw(3e-4)
                setup = jax_utils.setup_sharded_training(
                    lambda config=config: jt.init_params(config, jax.random.PRNGKey(0)), opt,
                    mesh=JaxMeshSpec({"dp": 1}).build(devices),
                    logical_dims=jt.param_logical_dims(config))
                step = jax_utils.build_sharded_train_step(loss, opt, setup, group_name=name)
                rows = np.split(np.arange(8), world)[rank]
                batch = jax.tree.map(lambda a: a[rows], batches[index])
                params, state, losses = setup.params, setup.opt_state, []
                for _ in range(SPLIT_STEPS):
                    params, state, value = step(params, state, setup.shard_batch(batch))
                    losses.append(float(value))
                results[("split", kind, world, rank)] = {"losses": losses, "params": {
                    "/".join(k.key for k in path): np.asarray(leaf) for path, leaf in
                    jax.tree_util.tree_flatten_with_path(params)[0]}}
        except BaseException as exc:  # noqa: BLE001 - raised by the caller
            errors.append(exc)
            barrier.abort()
        finally:
            jax_collective._groups.pop(name, None)

    threads = [threading.Thread(target=worker, args=(rank,)) for rank in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _jax_routing(h, router, config):
    """JAX's _moe_mlp on the global tokens h [tokens, dim]: its dispatch
    and combine, read at the einsums that take them."""
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jt

    captured = {}
    einsum = jnp.einsum

    def spy(spec, *args, **kwargs):
        if spec == "tec,td->ecd":
            captured["dispatch"] = np.asarray(args[0], np.float32)
        elif spec == "tec,ecd->td":
            captured["combine"] = np.asarray(args[0], np.float32)
        return einsum(spec, *args, **kwargs)

    jnp.einsum = spy
    try:
        layer = {"router": jnp.asarray(router), **{k: jnp.zeros((4, config.dim, config.hidden_dim))
                                                   for k in ("w_gate", "w_up")},
                 "w_down": jnp.zeros((4, config.hidden_dim, config.dim))}
        jt._moe_mlp(jnp.asarray(h)[None], layer, config)
    finally:
        jnp.einsum = einsum
    return captured["dispatch"], captured["combine"]


def _spawn(world, out_dir, init_trees, batches):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(rank, world, str(out_dir / f"store{world}"),
                                               str(out_dir), init_trees, batches))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


@pytest.fixture(scope="module")
def cases(tmp_path_factory, cpu_mesh_devices):
    import jax

    from ray_tpu.models import transformer as jt

    # The JAX setup's init (sharding-invariant, as it sets it) is what the
    # ranks are given.
    jax.config.update("jax_threefry_partitionable", True)
    out_dir = tmp_path_factory.mktemp("data_ranks")
    configs = {"dense": jt.TransformerConfig.tiny(), "moe": _moe_config(jt)}
    init_trees = {kind: jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(
        c, jax.random.PRNGKey(0))) for kind, c in configs.items()}
    moe_tokens, masked = _routing_batches()
    start = time.monotonic()
    procs = [p for world in (4, 2)
             for p in _spawn(world, out_dir, init_trees, (moe_tokens, masked))]
    try:
        # The reference runs while the ranks start and train.
        jax_results = {}
        moe_config, config = configs["moe"], configs["dense"]
        for meshes in MOE_MESHES.values():
            for name, axes in meshes.items():
                jax_results[("moe", name)] = _jax_one_step(
                    moe_config, axes, moe_tokens,
                    lambda p, tok: jt.loss_fn(p, tok[:, :-1], tok[:, 1:], moe_config),
                    cpu_mesh_devices)
        for meshes in MASK_MESHES.values():
            for name, axes in meshes.items():
                jax_results[("masked", name)] = _jax_one_step(
                    config, axes, masked, _masked_loss(jt, config), cpu_mesh_devices)
                jax_results[("regularised", name)] = _jax_one_step(
                    config, axes, masked,
                    _masked_loss(jt, config, lambda w: jax.numpy.sum(jax.numpy.square(w))),
                    cpu_mesh_devices)
        for world in (4, 2):
            jax_results.update(_jax_split_steps(world, (moe_tokens, masked), cpu_mesh_devices))
        for p in procs:
            p.join(max(1.0, JOIN_TIMEOUT_S - (time.monotonic() - start)))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    errors = [path.read_text() for path in sorted(out_dir.glob("error*.txt"))]
    assert not alive, f"{len(alive)} ranks outlasted {JOIN_TIMEOUT_S} s and were killed"
    assert not errors and all(p.exitcode == 0 for p in procs), "\n".join(errors)
    port_results, routing = {}, {}
    for world in (4, 2):
        for rank in range(world):
            with open(out_dir / f"results{world}_{rank}.pkl", "rb") as f:
                ranked = pickle.load(f)
            for key, value in ranked.items():
                if key[0] == "moe":
                    routing.setdefault(key[1], []).append(value.pop("routing"))
                if rank == 0 or key[0] == "split":
                    port_results[key] = value
    return port_results, jax_results, init_trees, routing


def _update_error(port, ref, init_tree):
    """Max |port - JAX| over the leaves' SGD(1.0) updates (minus the
    gradients)."""
    init = dict(("/".join(path), leaf) for path, leaf in tree_leaves(init_tree))
    assert port.keys() == ref.keys()
    return max(float(np.max(np.abs((port[n] - init[n]) - (ref[n] - init[n])))) for n in port)


MOE_CASES = [name for meshes in MOE_MESHES.values() for name in meshes]
MASK_CASES = [name for meshes in MASK_MESHES.values() for name in meshes]


@pytest.mark.parametrize("mesh", MOE_CASES)
def test_moe_on_data_ranks_routes_over_the_global_tokens(cases, mesh):
    """Every rank's dispatch, stacked in the data ranks' order, is JAX's
    _moe_mlp's on the global tokens exactly, drops included; the loss and
    gradients match JAX's sharded step."""
    port_results, jax_results, init_trees, routing = cases
    from ray_tpu.models import transformer as jt

    config = _moe_config(jt)
    ranks = routing[mesh]  # per rank: (tokens, combine) per MoE layer call
    routers = init_trees["moe"]["layers"]["router"]
    for layer in range(config.n_layers):
        h = np.concatenate([calls[layer][0] for calls in ranks])
        combine = np.concatenate([calls[layer][1] for calls in ranks])
        dispatch_j, combine_j = _jax_routing(h, routers[layer], config)
        assert combine.shape == combine_j.shape  # the global capacity
        np.testing.assert_array_equal((combine > 0).astype(np.float32), dispatch_j)
        assert float(np.max(np.abs(combine - combine_j))) < 1e-6
        assert dispatch_j.sum() < config.moe.top_k * h.shape[0]  # choices were dropped
    port, ref = port_results[("moe", mesh)], jax_results[("moe", mesh)]
    assert abs(port["loss"] - ref["loss"]) < F32_TOL
    assert _update_error(port["params"], ref["params"], init_trees["moe"]) < GRAD_TOL


@pytest.mark.parametrize("mesh", MASK_CASES)
def test_masked_loss_is_the_global_masked_mean(cases, mesh):
    """Masks whose counts differ across ranks: the port's loss and
    gradients are those of JAX's global masked mean, which the mean of the
    ranks' own masked means is not."""
    port_results, jax_results, init_trees, _ = cases
    port, ref = port_results[("masked", mesh)], jax_results[("masked", mesh)]
    assert abs(port["loss"] - ref["loss"]) < F32_TOL
    assert _update_error(port["params"], ref["params"], init_trees["dense"]) < GRAD_TOL
    # The fault this holds: the mean of per-rank masked means is another loss.
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jt

    _, masked = _routing_batches()
    config = jt.TransformerConfig.tiny()
    logits = jt.forward(init_trees["dense"], jnp.asarray(masked["tok"][:, :-1]), config)
    nll = -np.take_along_axis(np.asarray(jax.nn.log_softmax(logits, axis=-1)),
                              masked["tok"][:, 1:, None], -1)[..., 0]
    ranks = int(np.prod(list({**MASK_MESHES[4], **MASK_MESHES[2]}[mesh].values())))
    local = [(nll[r] * masked["mask"][r]).sum() / max(masked["mask"][r].sum(), 1.0)
             for r in np.split(np.arange(8), ranks)]
    assert abs(float(np.mean(local)) - ref["loss"]) > 1e-2


@pytest.mark.parametrize("mesh", MASK_CASES)
def test_masked_loss_plus_a_regulariser_is_the_global_mean(cases, mesh):
    """The masked loss plus a regulariser of the params: the loss and
    gradients are JAX's global mean of the sum, the regulariser's gradient
    counted once, not once a data rank."""
    port_results, jax_results, init_trees, _ = cases
    port, ref = port_results[("regularised", mesh)], jax_results[("regularised", mesh)]
    assert abs(port["loss"] - ref["loss"]) < F32_TOL
    assert _update_error(port["params"], ref["params"], init_trees["dense"]) < GRAD_TOL
    # The regulariser moved the final norm: its update is not the masked loss's.
    masked = port_results[("masked", mesh)]["params"]["final_norm"]
    assert float(np.max(np.abs(port["params"]["final_norm"] - masked))) > 1e-2


@pytest.mark.parametrize("world", [4, 2], ids=["dp4", "dp2"])
@pytest.mark.parametrize("kind", SPLIT_LOSSES)
def test_split_step_matches_the_reference_split_step(cases, kind, world):
    """Three AdamW steps of the split form from one init: each worker's
    losses and the final params match the reference's split form, in which
    each worker's masked mean and MoE routing cover its own rows (the masks'
    counts differ across the workers, and the last worker's rows of dp 4
    have none) and the gradients are averaged over the workers."""
    port_results, jax_results, _, _ = cases
    for rank in range(world):
        port = port_results[("split", kind, world, rank)]
        ref = jax_results[("split", kind, world, rank)]
        np.testing.assert_allclose(port["losses"], ref["losses"], rtol=0, atol=F32_TOL)
        assert port["params"].keys() == ref["params"].keys()
        err = max(float(np.max(np.abs(port["params"][n] - ref["params"][n])))
                  for n in port["params"])
        assert err < STEP_TOL, (rank, err)
    # The workers' own losses differ: each covers its own rows.
    first = [port_results[("split", kind, world, r)]["losses"][0] for r in range(world)]
    assert max(first) - min(first) > 1e-3
