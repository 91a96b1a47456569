"""Two tiers on the port: ``parallel.topology.SliceTopology`` and the
``hier`` collective backend, against the JAX package's.

* ``SliceTopology``'s validation, properties and mismatch errors equal the
  reference's (tests/test_multislice.py), message for message.
* The rank grid of ``build_mesh(domains=...)`` equals the device grid the
  reference's ``build_mesh`` makes from stand-in devices grouped by
  ``_group_by_domain`` (slice index, or process where there is none).
* On 4 gloo ranks in 2 domains ({"dp": 2} across, {"tp": 2} within):
  ``hierarchical_psum`` (both tiers, each alone), ``hierarchical_pmean``
  and ``grad_psum(topology=)`` against the reference's under
  ``jax.shard_map`` over ``Mesh(devices[:4].reshape(2, 2), ("dp", "tp"))``
  of the conftest's virtual CPU devices, f32 within 2e-5;
  ``HierarchicalGroup.allreduce_sharded`` with 2 shards a rank against the
  reference's ``_TIER1_HOST`` reduce of all 8 shards, and
  ``sync_gradients_hierarchical`` (hier and flat groups) against the
  reference's ``sync_gradients_sharded`` mean over the 8 shards.
* ``TorchTrainer(topology=...)`` reaches ``TrainContext.slice_topology``,
  and the session's mesh is the topology's.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from ray_tpu_torch.parallel.topology import SliceTopology, domain_grid
from ray_tpu_torch.train import session, torch_utils
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import TorchTrainer
from ray_tpu_torch.util import collective

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

WORLD = 4
DOMAINS = [[0, 1], [2, 3]]
TOPOLOGY = {"ici_axes": {"tp": 2}, "dcn_axes": {"dp": 2}}
# f32 sums of 2-8 terms in another order.
F32_TOL = 2e-5


def _errors(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("axes", [({"tp": 2}, {"tp": 2}), ({}, {"dp": 2}), ({"tp": 2}, {})],
                         ids=["both_tiers", "ici_empty", "dcn_empty"])
def test_validation_matches_the_reference(axes):
    from ray_tpu.parallel.topology import SliceTopology as RefTopology

    assert _errors(lambda: SliceTopology(*axes)) == _errors(lambda: RefTopology(*axes))


def test_properties_match_the_reference():
    from ray_tpu.parallel.topology import SliceTopology as RefTopology

    kwargs = {"ici_axes": {"tp": 2, "sp": 2}, "dcn_axes": {"dp": 2}}
    port, ref = SliceTopology(**kwargs), RefTopology(**kwargs)
    for name in ("num_slices", "devices_per_slice"):
        assert getattr(port, name) == getattr(ref, name)
    assert port.axis_names() == ref.axis_names() == ("dp", "tp", "sp")
    assert port.grad_sync_axes() == ref.grad_sync_axes() == ("dp",)


class _Device:
    """A stand-in for a jax device: what ``_group_by_domain`` reads."""

    def __init__(self, id, process_index, slice_index=None):
        self.id, self.process_index = id, process_index
        if slice_index is not None:
            self.slice_index = slice_index


def _ref_grid(monkeypatch, topology: dict, devices: list):
    """The reference's build_mesh on stand-in devices, its jax Mesh swapped
    for a recorder of the device grid."""
    import jax.sharding

    from ray_tpu.parallel.topology import SliceTopology as RefTopology

    monkeypatch.setattr(jax.sharding, "Mesh", lambda grid, names: (grid, names))
    grid, names = RefTopology(**topology).build_mesh(devices)
    return np.vectorize(lambda d: d.id)(grid), names


def _port_domains(devices: list) -> list:
    """The domains as the port takes them: ranks (device ids) grouped by slice
    index, or by process where the slice index is absent or constant, in
    the reference's key order."""
    from ray_tpu.parallel.topology import _group_by_domain

    groups = _group_by_domain(devices)
    return [[d.id for d in groups[key]] for key in sorted(groups)]


GRIDS = {
    "slice_index": ({"ici_axes": {"tp": 4}, "dcn_axes": {"dp": 2}},
                    [_Device(i, i // 2, slice_index=1 - i // 4) for i in (5, 2, 7, 0, 3, 6, 1, 4)]),
    "process": ({"ici_axes": {"tp": 2, "sp": 2}, "dcn_axes": {"dp": 2}},
                [_Device(i, i % 2) for i in (3, 6, 0, 1, 7, 2, 5, 4)]),
    "constant_slice": ({"ici_axes": {"tp": 2}, "dcn_axes": {"dp": 2, "pp": 2}},
                       [_Device(i, i // 2, slice_index=0) for i in (7, 1, 4, 2, 6, 0, 3, 5)]),
}


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_rank_grid_matches_the_reference(case, monkeypatch):
    topology, devices = GRIDS[case]
    want, names = _ref_grid(monkeypatch, topology, devices)
    topo = SliceTopology(**topology)
    got = domain_grid(_port_domains(devices), tuple(topo.dcn_axes.values()),
                      tuple(topo.ici_axes.values()))
    assert names == topo.axis_names()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("topology, slices", [
    ({"ici_axes": {"tp": 4}, "dcn_axes": {"dp": 2}}, [0] * 8),          # one domain, wants 2
    ({"ici_axes": {"tp": 2}, "dcn_axes": {"dp": 2}}, [0, 0, 0, 1, 1, 1]),  # 3 a domain, wants 2
], ids=["domains", "per_domain"])
def test_mismatch_errors_match_the_reference(topology, slices, monkeypatch):
    devices = [_Device(i, i, slice_index=s) for i, s in enumerate(slices)]
    if len(set(slices)) == 1:
        devices = [_Device(i, 0) for i in range(len(slices))]
    want = _errors(lambda: _ref_grid(monkeypatch, topology, devices))
    topo = SliceTopology(**topology)
    got = _errors(lambda: domain_grid(_port_domains(devices), tuple(topo.dcn_axes.values()),
                                      tuple(topo.ici_axes.values())))
    assert got == want


def test_one_rank_build_mesh_and_its_refusals():
    import torch.distributed as dist

    try:
        mesh = SliceTopology({"tp": 1}, {"dp": 1}).build_mesh("cpu")
        assert mesh.mesh_dim_names == ("dp", "tp") and mesh.mesh.tolist() == [[0]]
        assert "ICI domains" in _errors(
            lambda: SliceTopology({"tp": 1}, {"dp": 2}).build_mesh("cpu", domains=[[0]]))
        assert "do not cover" in _errors(
            lambda: SliceTopology({"tp": 1}, {"dp": 2}).build_mesh("cpu", domains=[[0], [0]]))
        with pytest.raises(ValueError, match="needs mesh="):
            torch_utils.grad_psum(torch.ones(2), topology=SliceTopology({"tp": 1}, {"dp": 1}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="initialized process group"):
        SliceTopology({"tp": 2}, {"dp": 1}).build_mesh("cpu")


# ---------------------------------------------------------------------------
# 4 gloo ranks in 2 domains
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((WORLD, 3, 5)).astype(np.float32)
    shards = rng.standard_normal((WORLD, 2, 3, 5)).astype(np.float32)
    grads = [[{"w": rng.standard_normal((2, 3)).astype(np.float32),
               "b": rng.standard_normal(4).astype(np.float32)} for _ in range(2)]
             for _ in range(WORLD)]
    return xs, shards, grads


def _rank(rank, xs, shards, grads):
    """One rank (module level: spawned children import it by name)."""
    from ray_tpu_torch.util.collective import HierarchicalGroup

    topo = SliceTopology(**TOPOLOGY)
    mesh = topo.build_mesh("cpu", domains=DOMAINS)
    x = torch.from_numpy(xs[rank])
    out = {"grid": mesh.mesh.tolist(), "names": mesh.mesh_dim_names,
           "psum": topo.hierarchical_psum(x, mesh).numpy(),
           "psum_ici": topo.hierarchical_psum(x, mesh, dcn=False).numpy(),
           "psum_dcn": topo.hierarchical_psum(x, mesh, ici=False).numpy(),
           "pmean": topo.hierarchical_pmean(x, mesh).numpy(),
           "grad_psum": torch_utils.grad_psum(x, topology=topo, mesh=mesh).numpy()}
    group = HierarchicalGroup(WORLD, rank, "hier-direct", backend="gloo")
    for op in ("sum", "max", "min"):
        out[f"sharded_{op}"] = group.allreduce_sharded(list(shards[rank]), op=op)
    as_tensors = group.allreduce_sharded([torch.from_numpy(s) for s in shards[rank]])
    out["sharded_tensor"] = (type(as_tensors).__name__, as_tensors.numpy())
    try:
        group.allreduce_sharded(list(shards[rank]), op="product")
    except ValueError as err:
        out["product"] = str(err)
    collective.init_collective_group(WORLD, rank, backend="hier", group_name="hier")
    collective.init_collective_group(WORLD, rank, backend="gloo", group_name="flat")
    trees = [{k: torch.from_numpy(v) for k, v in tree.items()} for tree in grads[rank]]
    for name in ("hier", "flat"):
        mean = torch_utils.sync_gradients_hierarchical(trees, name)
        out[f"{name}_mean"] = {k: v.numpy() for k, v in mean.items()}
    out["hier_backend"] = collective.get_group("hier").backend_name
    for name in ("hier", "flat"):
        collective.destroy_collective_group(name)
    return out


class _FlatGroup:
    """A stand-in group for the reference's gradient sync: one rank holding
    all 8 local shards, and no ``allreduce_sharded`` (the flat mean)."""

    world_size, rank, config = 1, 0, None


def _jax_reference(xs, shards, grads) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from ray_tpu.parallel.topology import SliceTopology as RefTopology
    from ray_tpu.train import jax_utils
    from ray_tpu.util.collective import collective as ref_collective

    topo = RefTopology(**TOPOLOGY)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("dp", "tp"))
    spec = P(("dp", "tp"))

    def run(fn):
        mapped = jax.shard_map(lambda x: fn(x[0])[None], mesh=mesh, in_specs=spec,
                               out_specs=spec)
        return np.asarray(mapped(jnp.asarray(xs)))

    out = {"psum": run(topo.hierarchical_psum),
           "psum_ici": run(lambda x: topo.hierarchical_psum(x, dcn=False)),
           "psum_dcn": run(lambda x: topo.hierarchical_psum(x, ici=False)),
           "pmean": run(topo.hierarchical_pmean),
           "grad_psum": run(lambda x: jax_utils.grad_psum(x, topology=topo))}
    every = shards.reshape(-1, *shards.shape[2:])
    tier1 = ref_collective.HierarchicalGroup._TIER1_HOST
    for op in ("sum", "max", "min"):
        out[f"sharded_{op}"] = tier1[op](every, axis=0)
    ref_collective._groups["flat-reference"] = _FlatGroup()
    try:
        out["mean"] = jax_utils.sync_gradients_sharded(
            [tree for rank in grads for tree in rank], "flat-reference", overlap=False)
    finally:
        del ref_collective._groups["flat-reference"]
    return out


def test_two_tiers_on_four_gloo_ranks_match_the_reference(tmp_path):
    xs, shards, grads = _inputs()
    ranks, ref = run_ranks(_rank, WORLD, tmp_path, (xs, shards, grads), timeout_s=180,
                           parent=lambda: _jax_reference(xs, shards, grads))
    for rank, out in enumerate(ranks):
        assert out["grid"] == DOMAINS and out["names"] == ("dp", "tp")
        for key in ("psum", "psum_ici", "psum_dcn", "pmean", "grad_psum", "sharded_sum"):
            want = ref[key][rank] if key != "sharded_sum" else ref[key]
            np.testing.assert_allclose(out[key], want, rtol=0, atol=F32_TOL, err_msg=key)
        for op in ("max", "min"):
            np.testing.assert_array_equal(out[f"sharded_{op}"], ref[f"sharded_{op}"])
        assert out["sharded_tensor"][0] == "Tensor"
        np.testing.assert_allclose(out["sharded_tensor"][1], ref["sharded_sum"], rtol=0,
                                   atol=F32_TOL)
        assert out["product"] == "hierarchical backend supports ops ['max', 'min', 'sum']"
        assert out["hier_backend"] == "hier"
        for name in ("hier", "flat"):
            for key in ("w", "b"):
                np.testing.assert_allclose(out[f"{name}_mean"][key], ref["mean"][key], rtol=0,
                                           atol=F32_TOL, err_msg=f"{name} {key}")
    # Tier by tier: the ICI sum is the domain's, the DCN sum the column's.
    np.testing.assert_allclose(ranks[0]["psum_ici"], xs[0] + xs[1], atol=F32_TOL)
    np.testing.assert_allclose(ranks[0]["psum_dcn"], xs[0] + xs[2], atol=F32_TOL)


# ---------------------------------------------------------------------------
# the trainer's topology=
# ---------------------------------------------------------------------------

def _topology_loop(config):
    """Each worker's loop (module level: the gang pickles it by name)."""
    ctx = session.get_context()
    topo = ctx.slice_topology
    mesh = torch_utils.build_mesh(topology=topo, device="cpu")
    session_mesh = torch_utils._session_mesh()
    summed = torch_utils.grad_psum(torch.full((2,), float(ctx.world_rank + 1)),
                                   topology=topo, mesh=mesh)
    session.report({"topology": (dict(topo.ici_axes), dict(topo.dcn_axes)),
                    "names": mesh.mesh_dim_names, "session_names": session_mesh.mesh_dim_names,
                    "grid": mesh.mesh.tolist(), "summed": summed.tolist()})


def test_trainer_topology_reaches_the_context(tmp_path):
    # Both workers run on this host: one domain of 2 ranks.
    topo = SliceTopology(ici_axes={"dp": 2}, dcn_axes={"fsdp": 1})
    result = TorchTrainer(_topology_loop,
                          scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
                          run_config=RunConfig(name="topology", storage_path=str(tmp_path)),
                          topology=topo).fit()
    assert result.error is None, result.error
    metrics = result.metrics
    assert metrics["topology"] == ({"dp": 2}, {"fsdp": 1})
    assert metrics["names"] == metrics["session_names"] == ("fsdp", "dp")
    assert metrics["grid"] == [[0, 1]] and metrics["summed"] == [3.0, 3.0]
