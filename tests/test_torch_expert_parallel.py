"""Expert parallelism of the port (the MoE block under ep and tp) against
the JAX package's sharded step, across processes.

Four spawned gloo ranks (``_torch_ranks.run_ranks``) train
``TransformerConfig.tiny(moe=MoEConfig(num_experts=4, top_k=2))`` through
``setup_sharded_training`` and ``build_sharded_train_step`` on {ep 4},
{dp 2, ep 2}, {tp 2, ep 2} and {fsdp 2, ep 2}; the JAX package runs its
own sharded setup and step on the same mesh shapes over the conftest's
virtual CPU devices meanwhile, from the same JAX init and batches:

  * one SGD(0.1) step: the loss and every gathered leaf (init minus 0.1
    times the gradient), at ``tests/test_torch_sharded.py``'s f32 bounds;
  * three AdamW(1e-2) steps (optax's ``adamw``, as ``make_optimizer``
    sets torch's) on fresh batches: the losses, and each leaf's update at
    that file's Adam bound.

The leaves' placements (the experts split over ep on their expert dim)
match JAX's plan. The refusals run in this process on a ``MeshSpec``
(planning builds no process group): rules that map "batch" or "expert"
otherwise than ``DEFAULT_RULES`` on an ep mesh, an expert count that ep
does not divide (the JAX package refuses it too, as a ``ValueError`` of
its planner), and the MoE block handed a share of experts that ep does not
make whole.

On a machine with four cards, ``test_expert_parallel_on_four_cards`` runs
the same steps on NCCL ranks, one a card, against the unsharded steps on
the first card (no JAX there); elsewhere it skips.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import tensor_parallel as tp
from ray_tpu_torch.parallel.mesh import LogicalRules, MeshSpec, tree_leaves, tree_map
from ray_tpu_torch.train import torch_utils
from ray_tpu_torch.train.step import make_optimizer

WORLD = 4
MESHES = {
    "ep4": {"ep": 4},
    "dp2_ep2": {"dp": 2, "ep": 2},
    "tp2_ep2": {"tp": 2, "ep": 2},
    "fsdp2_ep2": {"fsdp": 2, "ep": 2},
}
# tests/test_torch_sharded.py's bounds: the loss within TRAJECTORY_LOSS_TOL;
# after SGD(0.1) each gathered leaf within SGD_LEAF_TOL of JAX's; after
# Adam each leaf's update (final minus init) within ADAM_UPDATE_TOL by
# relative Frobenius norm (that file says why no max-abs bound holds).
TRAJECTORY_LOSS_TOL = 1e-4
SGD_LEAF_TOL = 2e-6
ADAM_UPDATE_TOL = 1e-3
SGD_LR, ADAM_LR, ADAM_STEPS = 0.1, 1e-2, 3
# ROADMAP Queue A item 4b: every refusal names it.
ITEM = "ROADMAP Queue A item 4b"


def _moe_config(module, **moe):
    return module.TransformerConfig.tiny(
        moe=module.MoEConfig(**{"num_experts": 4, "top_k": 2, **moe}))


def _batches():
    rng = np.random.default_rng(21)
    return [rng.integers(0, 256, (8, 17)).astype(np.int32) for _ in range(1 + ADAM_STEPS)]


# ------------------------------------------------------------- rank side
def _init_fn(tree):
    """init_fn(device) for setup_sharded_training from a numpy tree."""
    def init(device):
        if device == "meta":
            return tree_map(lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta"),
                            tree)
        return params_from_numpy(tree, device=device)
    return init


def _sgd(params):
    return torch.optim.SGD([leaf.requires_grad_(True) for _, leaf in tree_leaves(params)],
                           lr=SGD_LR)


def _run(init_tree, axes, optimizer, batches, device):
    """Steps of the sharded step on ``batches``: the losses, the gathered
    params and the leaves' specs."""
    config = _moe_config(pt)
    setup = torch_utils.setup_sharded_training(
        _init_fn(init_tree), optimizer, mesh=MeshSpec(axes).build(device),
        logical_dims=pt.param_logical_dims(config))
    step = torch_utils.build_sharded_train_step(
        lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], config), setup)
    params, opt_state, losses = setup.params, setup.opt_state, []
    for batch in batches:
        params, opt_state, value = step(params, opt_state,
                                        setup.shard_batch(torch.from_numpy(batch)))
        losses.append(float(value))
    return {"losses": losses,
            "params": {"/".join(path): leaf.full_tensor().detach().cpu().numpy()
                       for path, leaf in tree_leaves(params)},
            "specs": {"/".join(path): s.spec for path, s in tree_leaves(setup.param_shardings)}}


def _rank_cases(rank, init_tree, batches, meshes, device="cpu"):
    """Every mesh's SGD step and AdamW trajectory, with the ep collectives
    the MoE block issued in the SGD step."""
    out = {}
    for name, axes in meshes.items():
        tp.reset_calls()
        out[("sgd", name)] = _run(init_tree, axes, _sgd, batches[:1], device)
        out[("sgd", name)]["ep_calls"] = tp.calls["ep"]
        out[("adamw", name)] = _run(init_tree, axes, lambda p: make_optimizer(p, lr=ADAM_LR),
                                    batches[1:], device)
    return out


# ------------------------------------------------------------ parent side
def _jax_run(axes, kind, batches, devices):
    import jax
    import optax

    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.train import jax_utils

    config = _moe_config(jt)
    opt = optax.sgd(SGD_LR) if kind == "sgd" else optax.adamw(ADAM_LR)
    setup = jax_utils.setup_sharded_training(
        lambda: jt.init_params(config, jax.random.PRNGKey(0)), opt,
        mesh=JaxMeshSpec(axes).build(devices), logical_dims=jt.param_logical_dims(config))
    step = jax_utils.build_sharded_train_step(
        lambda p, tok: jt.loss_fn(p, tok[:, :-1], tok[:, 1:], config), opt, setup)
    params, opt_state, losses = setup.params, setup.opt_state, []
    for batch in batches:
        params, opt_state, value = step(params, opt_state, setup.shard_batch(batch))
        losses.append(float(value))
    flat = jax.tree_util.tree_flatten_with_path
    return {"losses": losses,
            "params": {"/".join(k.key for k in path): np.asarray(leaf)
                       for path, leaf in flat(params)[0]},
            "specs": {"/".join(k.key for k in path): tuple(s.spec)
                      for path, s in flat(setup.param_shardings)[0]}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_mesh_devices):
    import jax

    from ray_tpu.models import transformer as jt

    # The JAX setup's init (sharding-invariant, as it sets it) is what the
    # ranks are given.
    jax.config.update("jax_threefry_partitionable", True)
    init_tree = jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(
        _moe_config(jt), jax.random.PRNGKey(0)))
    batches = _batches()

    def reference():
        ref = {}
        for name, axes in MESHES.items():
            ref[("sgd", name)] = _jax_run(axes, "sgd", batches[:1], cpu_mesh_devices)
            ref[("adamw", name)] = _jax_run(axes, "adamw", batches[1:], cpu_mesh_devices)
        return ref

    results, ref = run_ranks(_rank_cases, WORLD, tmp_path_factory.mktemp("expert_parallel"),
                             (init_tree, batches, MESHES), timeout_s=180.0, parent=reference)
    init = {"/".join(path): leaf for path, leaf in tree_leaves(init_tree)}
    return results[0], ref, init


@pytest.mark.parametrize("mesh", list(MESHES))
def test_expert_parallel_step_matches_jax(runs, mesh):
    """One SGD step: the loss, and every leaf (so its gradient) within the
    f32 bounds; the experts split over ep as JAX's plan splits them; the
    ep sum and the ep gradient sums ran."""
    port, ref, _ = runs
    got, want = port[("sgd", mesh)], ref[("sgd", mesh)]
    assert got["specs"] == want["specs"]
    assert "ep" in got["specs"]["layers/w_gate"]
    assert "ep" not in got["specs"]["layers/router"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=TRAJECTORY_LOSS_TOL)
    assert got["params"].keys() == want["params"].keys()
    for name, leaf in got["params"].items():
        err = float(np.max(np.abs(leaf - want["params"][name])))
        assert err < SGD_LEAF_TOL, (name, err)
    # Per layer: the combine's sum over ep, and the gradient sums of the
    # block's input and of the router.
    assert got["ep_calls"] == 3 * pt.TransformerConfig.tiny().n_layers


@pytest.mark.parametrize("mesh", list(MESHES))
def test_expert_parallel_adamw_trajectory_matches_jax(runs, mesh):
    port, ref, init = runs
    got, want = port[("adamw", mesh)], ref[("adamw", mesh)]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=TRAJECTORY_LOSS_TOL)
    for name, leaf in got["params"].items():
        update = want["params"][name] - init[name]
        err = float(np.linalg.norm(leaf - want["params"][name])
                    / max(np.linalg.norm(update), 1e-30))
        assert err < ADAM_UPDATE_TOL, (name, err)


# ------------------------------------------------------------ refusals
def _plan(config, axes, rules=None):
    return torch_utils.plan_sharded_training(
        lambda device: pt.init_params(config, 0, device), mesh=MeshSpec(axes),
        logical_dims=pt.param_logical_dims(config), rules=rules)


@pytest.mark.parametrize("override", [{"expert": None}, {"expert": "dp"},
                                      {"batch": ("dp", "fsdp", "ep")}],
                         ids=["expert_whole", "expert_on_dp", "batch_on_ep"])
def test_rules_other_than_the_defaults_are_refused_under_ep(override):
    rules = LogicalRules().with_overrides(**override)
    with pytest.raises(NotImplementedError, match=ITEM):
        _plan(_moe_config(pt), {"dp": 2, "ep": 2}, rules)
    # Without ep the same rules plan.
    _plan(_moe_config(pt), {"dp": 2, "fsdp": 2}, rules)


def test_an_expert_count_ep_does_not_divide_is_refused(cpu_mesh_devices):
    """The port refuses 6 experts on ep 4, naming the item; the JAX package
    refuses them too (its planner's ValueError), so neither pads."""
    import jax
    import optax

    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.train import jax_utils

    with pytest.raises(NotImplementedError, match=ITEM):
        _plan(_moe_config(pt, num_experts=6), {"ep": 4})
    _plan(_moe_config(pt, num_experts=8), {"ep": 4})
    config = _moe_config(jt, num_experts=6)
    with pytest.raises(ValueError, match="evenly divide"):
        jax_utils.setup_sharded_training(
            lambda: jt.init_params(config, jax.random.PRNGKey(0)), optax.adamw(1e-2),
            mesh=JaxMeshSpec({"ep": 4}).build(cpu_mesh_devices),
            logical_dims=jt.param_logical_dims(config))


def test_the_moe_block_refuses_a_share_ep_does_not_make_whole():
    config = _moe_config(pt, num_experts=6)
    layer = {name: leaf[0, :1] if name.startswith("w_") else leaf[0]
             for name, leaf in pt.init_params(config, 0, "cpu")["layers"].items()}
    ctx = tp.TPContext(group=None, rank=0, size=1, ep=4, ep_rank=1)
    with tp.tensor_parallel(ctx), pytest.raises(NotImplementedError, match=ITEM):
        pt._moe_mlp(torch.zeros(1, 4, config.dim), layer, config)


# ------------------------------------------------------------ four cards
def _single_card(init_tree, optimizer, batches):
    """The same steps on one card, unsharded."""
    config = _moe_config(pt)
    params = params_from_numpy(init_tree, device="cuda")
    opt, losses = optimizer(params), []
    for batch in batches:
        tok = torch.from_numpy(batch).cuda()
        loss = pt.loss_fn(params, tok[:, :-1], tok[:, 1:], config)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    return {"losses": losses, "params": {"/".join(path): leaf.detach().cpu().numpy()
                                         for path, leaf in tree_leaves(params)}}


def _card_cases(rank, init_tree, batches):
    return _rank_cases(rank, init_tree, batches, MESHES, "cuda")


@pytest.mark.cuda
def test_expert_parallel_on_four_cards(tmp_path):
    """NCCL ranks, one a card, against the unsharded steps on the first
    card: the loss within TRAJECTORY_LOSS_TOL, each leaf's update within
    ADAM_UPDATE_TOL by relative Frobenius norm (the sums over ep and tp
    run in other orders than one card's einsums)."""
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards, found {torch.cuda.device_count()}")
    from ray_tpu_torch import _build

    _build.library()  # built once here, loaded by every rank
    init_tree = tree_map(lambda t: t.numpy(), pt.init_params(_moe_config(pt), 0, "cpu"))
    batches = _batches()

    def reference():
        return {"sgd": _single_card(init_tree, _sgd, batches[:1]),
                "adamw": _single_card(init_tree, lambda p: make_optimizer(p, lr=ADAM_LR),
                                      batches[1:])}

    results, ref = run_ranks(_card_cases, WORLD, tmp_path, (init_tree, batches),
                             timeout_s=300.0, parent=reference, backend="nccl")
    init = {"/".join(path): leaf for path, leaf in tree_leaves(init_tree)}
    errs = {}
    for (kind, mesh), got in results[0].items():
        want = ref[kind]
        loss_err = float(np.max(np.abs(np.subtract(got["losses"], want["losses"]))))
        update_err = max(
            float(np.linalg.norm(leaf - want["params"][name])
                  / max(np.linalg.norm(want["params"][name] - init[name]), 1e-30))
            for name, leaf in got["params"].items())
        errs[(kind, mesh)] = (loss_err, update_err)
    print(f"loss and worst update errors {errs}")  # the measurement, with -s
    for (kind, mesh), (loss_err, update_err) in errs.items():
        assert loss_err < TRAJECTORY_LOSS_TOL, (kind, mesh, errs)
        assert update_err < ADAM_UPDATE_TOL, (kind, mesh, errs)
