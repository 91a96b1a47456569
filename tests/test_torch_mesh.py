"""The port's mesh, sharding policy and planning against the JAX package's,
in one process.

The policy (``LogicalRules.spec``, ``fsdp_extend_spec``,
``auto_shard_specs``) is pure on both sides: the port's takes a
``MeshSpec``, JAX's a mesh over the conftest's 8 virtual CPU devices, and
every leaf's spec must be equal, as must the planned bytes per device. The
edge cases and the budget refusal mirror ``tests/test_sharding.py``. A
one-rank gloo group (started by ``MeshSpec.build``, destroyed after each
test) holds the placements and the sharded step against the single-device
``train_step``, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from ray_tpu.models import transformer as jt
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.train import jax_utils
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.parallel import mesh as port_mesh
from ray_tpu_torch.parallel import tensor_parallel as tp
from ray_tpu_torch.parallel.mesh import MeshSpec, NamedSharding
from ray_tpu_torch.train import torch_utils
from ray_tpu_torch.train.step import make_optimizer, named_leaves, train_step


def _bench_sharded(module, dtype):
    """bench.py's sharded config (bench.py:133-138)."""
    return module.TransformerConfig(
        vocab_size=8192, dim=4096, n_layers=4, n_heads=32, n_kv_heads=32, hidden_dim=16384,
        max_seq=1024, dtype=dtype)


CONFIGS = {
    "tiny": (lambda: jt.TransformerConfig.tiny(), lambda: pt.TransformerConfig.tiny()),
    "tiny_moe": (lambda: jt.TransformerConfig.tiny(moe=jt.MoEConfig(num_experts=4, top_k=2)),
                 lambda: pt.TransformerConfig.tiny(moe=pt.MoEConfig(num_experts=4, top_k=2))),
    "llama2_7b": (lambda: jt.TransformerConfig.llama2_7b(),
                  lambda: pt.TransformerConfig.llama2_7b()),
    "bench_sharded": (lambda: _bench_sharded(jt, jnp.bfloat16),
                      lambda: _bench_sharded(pt, torch.bfloat16)),
}
MESHES = {
    "dp8": {"dp": 8},
    "fsdp8": {"fsdp": 8},
    "tp8": {"tp": 8},
    "dp2_fsdp2_tp2": {"dp": 2, "fsdp": 2, "tp": 2},
    "dp4_fsdp2": {"dp": 4, "fsdp": 2},
    "fsdp4_tp2": {"fsdp": 4, "tp": 2},
    "dp2_ep4": {"dp": 2, "ep": 4},
    # The meshes tests/test_torch_expert_parallel.py trains on.
    "ep4": {"ep": 4},
    "dp2_ep2": {"dp": 2, "ep": 2},
    "tp2_ep2": {"tp": 2, "ep": 2},
    "fsdp2_ep2": {"fsdp": 2, "ep": 2},
}


def _jax_plan(config, axes, devices):
    shapes = jax.eval_shape(lambda: jt.init_params(config, jax.random.PRNGKey(0)))
    mesh = jax_mesh.MeshSpec(axes).build(devices)
    shardings = jax_mesh.auto_shard_specs(shapes, mesh,
                                          logical_dims=jt.param_logical_dims(config))
    return shapes, shardings


def _port_plan(config, axes):
    shapes = pt.init_params(config, 0, "meta")
    shardings = port_mesh.auto_shard_specs(shapes, MeshSpec(axes),
                                           logical_dims=pt.param_logical_dims(config))
    return shapes, shardings


@pytest.fixture
def one_rank_group():
    """Leaves no process group behind for the next test in this process."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_every_leaf_spec_and_the_planned_bytes_match_jax(cpu_mesh_devices, config, mesh):
    jax_config, port_config = (make() for make in CONFIGS[config])
    jax_shapes, jax_shardings = _jax_plan(jax_config, MESHES[mesh], cpu_mesh_devices)
    port_shapes, port_shardings = _port_plan(port_config, MESHES[mesh])
    jax_specs = {tuple(k.key for k in path): tuple(s.spec) for path, s in
                 jax.tree_util.tree_flatten_with_path(jax_shardings)[0]}
    port_specs = {path: s.spec for path, s in port_mesh.tree_leaves(port_shardings)}
    assert port_specs == jax_specs
    assert (torch_utils.state_bytes_per_device(port_shapes, port_shardings)
            == jax_utils.state_bytes_per_device(jax_shapes, jax_shardings))
    assert (torch_utils.ensure_train_state_fits(port_shapes, port_shardings, budget=float("inf"))
            == jax_utils.ensure_train_state_fits(jax_shapes, jax_shardings,
                                                 budget=float("inf")))


# ------------------------------------------------- test_sharding.py's edges
def test_spec_axis_not_in_mesh_degrades_to_replication(cpu_mesh_devices):
    tree = {"w": torch.empty(16, 32, device="meta")}
    specs = port_mesh.auto_shard_specs(tree, MeshSpec({"dp": 8}),
                                       logical_dims={"w": ("embed", "mlp")})
    assert specs["w"].spec == (None, None)
    ref = jax_mesh.auto_shard_specs({"w": jax.ShapeDtypeStruct((16, 32), jnp.float32)},
                                    jax_mesh.MeshSpec({"dp": 8}).build(cpu_mesh_devices),
                                    logical_dims={"w": ("embed", "mlp")})
    assert tuple(ref["w"].spec) == specs["w"].spec


def test_spec_explicit_dims_win_then_fsdp_fills():
    mesh = MeshSpec({"dp": 2, "fsdp": 2, "tp": 2})
    tree = {"w": torch.empty(16, 32, device="meta"), "plain": torch.empty(16, 32, device="meta")}
    specs = port_mesh.auto_shard_specs(tree, mesh, logical_dims={"w": ("embed", "mlp")})
    assert specs["w"].spec == ("fsdp", "tp")
    assert specs["plain"].spec == (None, "fsdp")


def test_fsdp_policy_uneven_divisibility_falls_back(cpu_mesh_devices):
    mesh = MeshSpec({"fsdp": 2})
    assert port_mesh.fsdp_extend_spec((255, 512), (None, None), mesh) == (None, "fsdp")
    assert port_mesh.fsdp_extend_spec((255, 511), (None, None), mesh) == (None, None)
    jmesh = jax_mesh.MeshSpec({"fsdp": 2}).build(cpu_mesh_devices[:2])
    assert jax_mesh.fsdp_extend_spec((255, 512), P(None, None), jmesh) == P(None, "fsdp")


def test_fsdp_policy_skips_scalar_and_1d_leaves():
    tree = {"scale": torch.empty(128, device="meta"), "scalar": torch.empty((), device="meta")}
    specs = port_mesh.auto_shard_specs(tree, MeshSpec({"dp": 4, "fsdp": 2}))
    assert specs["scale"].spec == (None,)
    assert specs["scalar"].spec == ()


@pytest.mark.parametrize("dims", [("batch", None), ("batch", "seq"), ("vocab", "embed")])
def test_tuple_and_single_axis_rules_match_jax(cpu_mesh_devices, dims):
    """The batch rule's tuple of axes (dp-major), and each single-axis rule,
    as JAX's PartitionSpec holds them."""
    for axes in ({"dp": 2, "fsdp": 4}, {"fsdp": 8}, {"dp": 2, "sp": 2, "tp": 2}):
        ref = jax_mesh.LogicalRules().spec(dims, jax_mesh.MeshSpec(axes).build(cpu_mesh_devices))
        assert port_mesh.LogicalRules().spec(dims, MeshSpec(axes)) == tuple(ref)


# --------------------------------------------------------- MeshSpec rules
def test_meshspec_orders_axes_and_keeps_size_one_axes():
    spec = MeshSpec({"tp": 2, "dp": 1, "fsdp": 4})
    assert spec.axis_names() == ("dp", "fsdp", "tp")
    assert spec.size == 8
    assert MeshSpec({}).axis_names() == ("dp",) and MeshSpec({}).size == 1
    assert port_mesh.mesh_axes(spec) == {"dp": 1, "fsdp": 4, "tp": 2}


@pytest.mark.parametrize("axes,error", [({"xp": 2}, "unknown mesh axis"),
                                        ({"dp": 0}, "positive")])
def test_meshspec_errors(axes, error):
    with pytest.raises(ValueError, match=error):
        MeshSpec(axes)
    with pytest.raises(ValueError, match=error):
        jax_mesh.MeshSpec(axes)


def test_a_mesh_of_many_ranks_needs_a_process_group_of_as_many():
    # No group up, or one of another size: either way it raises.
    with pytest.raises((RuntimeError, ValueError), match="4 ranks"):
        MeshSpec({"dp": 4}).build("cpu")


def test_mesh_factorization_of_a_spec():
    assert torch_utils.mesh_factorization(MeshSpec({"dp": 2, "fsdp": 2, "tp": 2})) == {
        "dp": 2, "fsdp": 2, "tp": 2, "pp": 1}


# ------------------------------------------------------------ the budget
def test_replicated_path_refuses_over_budget(monkeypatch):
    """test_sharding.py's refusal: the replicated path refuses a state
    that can't fit; the sharded plan on {dp 2, fsdp 4} accepts it under the
    same budget and really shards over fsdp."""
    config = pt.TransformerConfig(vocab_size=64, dim=16, n_layers=2, n_heads=2, n_kv_heads=2,
                                  hidden_dim=32, max_seq=16, dtype=torch.float32)
    shapes = pt.init_params(config, 0, "meta")
    replicated = torch_utils.state_bytes_per_device(shapes) * 12 // 10
    monkeypatch.setenv("RAY_TPU_HBM_BYTES", str(replicated * 3))
    with pytest.raises(torch_utils.MemoryBudgetError, match="replicated train state"):
        torch_utils.shard_params(pt.init_params(config, 0, "cpu"), MeshSpec({"dp": 8}))
    _, shardings, estimate = torch_utils.plan_sharded_training(
        lambda d: pt.init_params(config, 0, d), mesh=MeshSpec({"dp": 2, "fsdp": 4}),
        logical_dims=pt.param_logical_dims(config))
    assert estimate <= replicated * 3
    assert any("fsdp" in str(s.spec) for _, s in port_mesh.tree_leaves(shardings))


def test_enforce_budget_false_is_an_infinite_budget(monkeypatch):
    monkeypatch.setenv("RAY_TPU_HBM_BYTES", "1")
    config = pt.TransformerConfig.tiny()
    with pytest.raises(torch_utils.MemoryBudgetError):
        torch_utils.plan_sharded_training(lambda d: pt.init_params(config, 0, d),
                                          mesh=MeshSpec({"dp": 1}))
    torch_utils.plan_sharded_training(lambda d: pt.init_params(config, 0, d),
                                      mesh=MeshSpec({"dp": 1}), enforce_budget=False)


def test_device_memory_budget(monkeypatch):
    monkeypatch.setenv("RAY_TPU_HBM_BYTES", "80e9")
    assert torch_utils.device_memory_budget() == 80_000_000_000
    monkeypatch.delenv("RAY_TPU_HBM_BYTES")
    assert torch_utils.device_memory_budget("cpu") is None


# ------------------------------------------------- what the slice refuses
def test_uneven_tensor_parallel_shards_are_refused():
    with pytest.raises(ValueError, match="ROADMAP Queue C"):
        torch_utils.plan_sharded_training(
            lambda d: pt.init_params(pt.TransformerConfig.tiny(), 0, d),
            mesh=MeshSpec({"tp": 3}), logical_dims=pt.param_logical_dims(
                pt.TransformerConfig.tiny()))
    # n_heads 3 at head_dim 16 over tp 2: wq's 48 columns split, its heads
    # do not.
    ctx = tp.TPContext(group="tp", rank=0, size=2)
    with pytest.raises(ValueError, match="n_heads=3.*ROADMAP Queue C"):
        tp.local_heads(ctx, 3, 24 // 16)
    assert tp.local_heads(tp.TPContext(group="tp", rank=1, size=2), 4, 2) == (2, 2)
    assert tp.local_heads(None, 4, 4) == (0, 4)


def test_other_tensor_parallel_rules_are_refused():
    config = pt.TransformerConfig.tiny()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 3a"):
        torch_utils.setup_sharded_training(
            lambda d: pt.init_params(config, 0, d), make_optimizer, mesh=MeshSpec({"tp": 2}),
            logical_dims=pt.param_logical_dims(config),
            rules=port_mesh.LogicalRules().with_overrides(heads=None))


# ---------------------------------------------------- one rank, in process
def test_placements_on_a_device_mesh(one_rank_group):
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshSpec({"dp": 1, "fsdp": 1, "tp": 1}).build("cpu")
    assert mesh.mesh_dim_names == ("dp", "fsdp", "tp")
    assert NamedSharding(mesh, (None, "fsdp", "tp")).placements() == (
        Replicate(), Shard(1), Shard(2))
    batch = port_mesh.LogicalRules().sharding(["batch", None], mesh)
    assert batch.spec == (("dp", "fsdp"), None)
    assert batch.placements() == (Shard(0), Shard(0), Replicate())


def test_build_mesh_and_the_batch_helpers(one_rank_group):
    from torch.distributed.tensor import Replicate, Shard

    mesh = torch_utils.build_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("dp",) and mesh.size() == 1
    batch = torch_utils.shard_batch({"x": torch.arange(6).view(3, 2)}, mesh)
    assert batch["x"].placements == (Shard(0),)
    assert torch.equal(batch["x"].to_local(), torch.arange(6).view(3, 2))
    mesh3 = MeshSpec({"dp": 1, "fsdp": 1, "tp": 1}).build("cpu")
    tokens = port_mesh.shard_batch(torch.zeros(4, 5), mesh3)
    assert tokens.placements == (Shard(0), Shard(0), Replicate())
    assert list(torch_utils.iter_global_batches(range(7), world_rank=1, world_size=3)) == [1, 4]


def test_one_rank_sharded_step_is_the_train_step(one_rank_group):
    """On a one-rank mesh the sharded step runs the single-device step's
    ops, plus collectives of one rank: three steps give the same losses
    and parameters, bitwise, and the tp and fsdp collectives are counted;
    so does a fourth through a one-worker collective group."""
    config = pt.TransformerConfig.tiny()
    mesh = MeshSpec({"dp": 1, "fsdp": 1, "tp": 1}).build("cpu")
    setup = torch_utils.setup_sharded_training(
        lambda d: pt.init_params(config, 0, d), make_optimizer, mesh=mesh,
        logical_dims=pt.param_logical_dims(config))
    assert setup.factorization == {"dp": 1, "fsdp": 1, "tp": 1, "pp": 1}
    step = torch_utils.build_sharded_train_step(
        lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], config), setup)
    ref = pt.init_params(config, 0, "cpu")
    optimizer = make_optimizer(ref)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 33)))
    params, opt_state = setup.params, setup.opt_state
    for _ in range(3):
        tp.reset_calls()
        params, opt_state, loss = step(params, opt_state, setup.shard_batch(tokens))
        assert torch.equal(loss, train_step(ref, optimizer, tokens, config))
        assert tp.calls["tp"] > 0 and tp.calls["fsdp"] > 0
    for (name, got), (_, want) in zip(named_leaves(params), named_leaves(ref)):
        assert torch.equal(got.full_tensor(), want.detach()), name
    # With a collective group of one worker the step is the fused one (the
    # reference's split form runs across two or more workers); a group
    # that was never formed raises.
    from ray_tpu_torch.util import collective

    collective.init_collective_group(1, 0, backend="gloo", group_name="g")
    try:
        step = torch_utils.build_sharded_train_step(
            lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], config), setup,
            group_name="g")
        params, opt_state, loss = step(params, opt_state, setup.shard_batch(tokens))
        assert torch.equal(loss, train_step(ref, optimizer, tokens, config))
    finally:
        collective.destroy_collective_group("g")
    with pytest.raises(ValueError, match="not initialized"):
        torch_utils.build_sharded_train_step(lambda p, b: 0, setup, group_name="g")
