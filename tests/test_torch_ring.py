"""The port's ring backend (``ray_tpu_torch.util.collective.RingGroup``)
against the reference's ``RingGroup`` (``ray_tpu/util/collective/
collective.py``) run on the reference's runtime: the same functions run in
a reference ``WorkerGang(backend="ring")`` on ``ray_start_shared`` and in
the port's ``WorkerGang(backend="ring", use_gpu=False)`` (CPU actors of
the module's cluster meeting in a gloo process group's store), on the same seeded
inputs, and every result is held bitwise: allreduce (sum, max, min,
product; int arrays on the exact wire), four quantized allreduces in a row
(error feedback carried between them), allgather, broadcast, reducescatter
on uneven chunks, barrier and send/recv. Also: the wire's size (exact: the
input dtype, no upcast; int8: under half the f32 ideal), a member's death,
and a hierarchical group whose slow tier is the ring.
"""

import os

import numpy as np
import pytest

from ray_tpu.util.collective.quantization import CollectiveConfig as RefConfig
from ray_tpu.util.gang import WorkerGang as RefGang
import ray_tpu_torch
from ray_tpu_torch.util.collective import CollectiveConfig
from ray_tpu_torch.util.gang import GangDiedError, WorkerGang

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

QCONFIG = {"quantize": "int8", "block_size": 128}


@pytest.fixture(scope="module")
def gangs(ray_start_shared):
    """The reference's and the port's gangs, by (world size, quantized),
    made on first use and shut down at the module's end."""
    made: dict = {}
    cpus = ray_tpu_torch.cluster_resources().get("CPU", 0.0)  # what the port's gangs lease

    def get(world: int, quantized: bool = False):
        key = (world, quantized)
        if key not in made:
            # The port's gangs lease the cluster's CPUs: make room.
            while made and sum(k[0] for k in made) + world > cpus:
                ref, port = made.pop(next(iter(made)))
                ref.shutdown()
                port.shutdown()
            ref = RefGang(world, backend="ring",
                          collective_config=RefConfig(**QCONFIG) if quantized else None)
            port = WorkerGang(world, use_gpu=False, backend="ring",
                              collective_config=CollectiveConfig(**QCONFIG) if quantized
                              else None)
            made[key] = (ref, port)
        return made[key]

    yield get
    for ref, port in made.values():
        ref.shutdown()
        port.shutdown()


def _both(gangs, fn, world=3, quantized=False, **kwargs):
    ref, port = gangs(world, quantized)
    return ref.run(fn, timeout=120, **kwargs), port.run(fn, timeout=120, **kwargs)


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _reductions(ctx, seed):
    coll = ctx.collective()
    rng = np.random.default_rng(seed + ctx.rank)
    x = rng.standard_normal(1001).astype(np.float32)
    ints = rng.integers(-40, 40, 37).astype(np.int64)
    small = (1.0 + 0.1 * rng.standard_normal(50)).astype(np.float32)
    return {
        "sum": coll.allreduce(x, tag="red"),
        "max": coll.allreduce(x, op="max"),
        "min": coll.allreduce(x, op="min"),
        "product": coll.allreduce(small, op="product"),
        "int_sum": coll.allreduce(ints),
        "int_product": coll.allreduce(ints % 5 + 1, op="product"),
        "f64": coll.allreduce(x.astype(np.float64), tag="f64"),
    }


@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int8"])
def test_allreduce_every_op_is_the_reference(gangs, quantized):
    ref, port = _both(gangs, _reductions, quantized=quantized, seed=3)
    for r, p in zip(ref, port):
        for key in r:
            assert _bitwise(p[key], r[key]), key
    # Every rank decodes the same bytes: the quantized sum agrees across ranks.
    assert all(_bitwise(p["sum"], port[0]["sum"]) for p in port)


def _four_quantized(ctx, seed):
    coll = ctx.collective()
    rng = np.random.default_rng(seed + ctx.rank)
    return [coll.allreduce(rng.standard_normal(4000).astype(np.float32), tag="ef")
            for _ in range(4)]


def test_four_quantized_allreduces_carry_error_feedback_as_the_reference(gangs):
    ref, port = _both(gangs, _four_quantized, quantized=True, seed=5)
    for r, p in zip(ref, port):
        assert all(_bitwise(a, b) for a, b in zip(p, r))
    exact = np.sum([np.random.default_rng(5 + k).standard_normal(4000).astype(np.float32)
                    for k in range(3)], axis=0)
    assert np.abs(port[0][0] - exact).max() < 0.1


def _gather_bcast_p2p(ctx, seed):
    coll = ctx.collective()
    rng = np.random.default_rng(seed + ctx.rank)
    x = rng.standard_normal((7, 3)).astype(np.float32)
    got = None
    if ctx.rank == 0:
        coll.send(x * 2, 2)
    elif ctx.rank == 2:
        got = coll.recv(0)
    coll.barrier()
    coll.barrier()
    return {"gather": coll.allgather(x), "bcast": coll.broadcast(x, src_rank=1),
            "recv": got, "x": x}


def test_allgather_broadcast_barrier_and_p2p_are_the_reference(gangs):
    ref, port = _both(gangs, _gather_bcast_p2p, seed=9)
    for r, p in zip(ref, port):
        assert all(_bitwise(a, b) for a, b in zip(p["gather"], r["gather"]))
        assert _bitwise(p["bcast"], r["bcast"]) and _bitwise(p["bcast"], port[1]["x"])
    assert _bitwise(port[2]["recv"], ref[2]["recv"])
    assert _bitwise(port[2]["recv"], port[0]["x"] * 2)


def _wire(ctx, n):
    coll = ctx.collective()
    coll.wire_stats["bytes_sent"] = 0
    coll.wire_stats["msgs_sent"] = 0
    out = coll.allreduce(np.ones(n, dtype=np.float32))
    assert out.dtype == np.float32
    return dict(coll.wire_stats)


@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int8"])
def test_wire_size(gangs, quantized):
    """The exact wire carries the input dtype (within framing of the f32
    ideal, 2 (w - 1) messages); the int8 wire is under half of it."""
    n, world = 30_000, 3
    ideal = 2 * (world - 1) * (n // world) * 4
    _, port = gangs(world, quantized)
    for stats in port.run(_wire, timeout=120, n=n):
        assert stats["msgs_sent"] == 2 * (world - 1)
        if quantized:
            assert stats["bytes_sent"] < 0.5 * ideal
        else:
            assert ideal <= stats["bytes_sent"] <= ideal * 1.25


def _uneven(ctx, n):
    coll = ctx.collective()
    arr = np.arange(n, dtype=np.float32) + float(ctx.rank)
    return coll.allreduce(arr), coll.reducescatter(arr, op="sum"), coll.allgather(arr)


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("world", [3, 2, 4])
def test_uneven_chunks_are_the_reference(gangs, world, n):
    """np.array_split with fewer elements than ranks gives empty chunks."""
    ref, port = _both(gangs, _uneven, world=world, n=n)
    expected = np.arange(n, dtype=np.float32) * world + sum(range(world))
    for rank, (r, p) in enumerate(zip(ref, port)):
        assert _bitwise(p[0], r[0]) and _bitwise(p[1], r[1])
        assert all(_bitwise(a, b) for a, b in zip(p[2], r[2]))
        assert p[0].tolist() == expected.tolist()
        assert p[1].tolist() == np.array_split(expected, world)[rank].tolist()


def _hier_ring(ctx):
    """A hierarchical group whose tier 2 is a ring, in the gang's store."""
    import torch

    from ray_tpu_torch.util.collective import HierarchicalGroup

    group = HierarchicalGroup(ctx.world_size, ctx.rank, f"{ctx.group_name}-hier",
                              backend="ring")
    try:
        shards = [torch.full((6,), float(ctx.rank * 2 + i)) for i in range(2)]
        out = group.allreduce_sharded(shards)
        host = group.allreduce_sharded([s.numpy() for s in shards], tag="host")
        return out.numpy(), host, group.backend_name, group._dcn.backend_name
    finally:
        group.destroy()


def test_hierarchical_group_takes_a_ring_tier(gangs):
    _, port = gangs(2)
    for out, host, name, tier in port.run(_hier_ring, timeout=120):
        assert (name, tier) == ("hier", "ring")
        assert out.tolist() == host.tolist() == [6.0] * 6  # 0 + 1 + 2 + 3


def _crash_rank_1(ctx):
    if ctx.rank == 1:
        os._exit(1)
    return ctx.collective().allreduce(np.ones(3), tag="doomed")


def test_member_death_raises():
    doomed = WorkerGang(2, use_gpu=False, backend="ring")
    try:
        with pytest.raises(GangDiedError):
            doomed.run(_crash_rank_1, timeout=120)
    finally:
        doomed.shutdown()


def test_a_ring_member_may_take_a_share_of_a_card_nccl_may_not():
    with pytest.raises(ValueError, match="whole card"):
        WorkerGang(2, use_gpu=True, resources_per_worker={"GPU": 0.5})
    with pytest.raises(ValueError, match="gang backend"):
        WorkerGang(2, use_gpu=False, backend="xla")
