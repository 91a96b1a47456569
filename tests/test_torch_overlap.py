"""The port's bucketed overlap (``ray_tpu_torch.util.collective.bucketing``
and ``overlap``, ``train.torch_utils.begin_gradient_sync``) against the
reference's (``ray_tpu/util/collective/bucketing.py``, ``overlap.py``,
``tests/test_overlap.py``): the same partition (ids, bytes and tags) for the
sharded config's leaves and for mixed ones, the same segments, the
overlapped sync bitwise equal to the monolithic one on a 2-rank ring,
``CollectiveConfig(overlap=True)`` routing ``sync_gradients_sharded
(overlap=None)``, and the exposed communication time recorded.
"""

import time

import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.util.collective import bucketing as ref_bucketing
from ray_tpu_torch.models.transformer import TransformerConfig, init_params
from ray_tpu_torch.train import step_stats
from ray_tpu_torch.train.step import named_leaves
from ray_tpu_torch.util.collective import CollectiveConfig, bucketing
from ray_tpu_torch.util.gang import WorkerGang

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

# bench.py's sharded config (chip_smoke.py phase 29's).
SHARDED = dict(vocab_size=8192, dim=4096, n_layers=4, n_heads=32, n_kv_heads=32,
               hidden_dim=16384, max_seq=1024, dtype=torch.bfloat16)
_NP_OF = {torch.bfloat16: np.dtype(ml_dtypes.bfloat16), torch.float32: np.dtype(np.float32),
          torch.float16: np.dtype(np.float16), torch.int32: np.dtype(np.int32)}


def _ref_leaves(leaves):
    """numpy stand-ins of the same shapes and dtypes, without their memory."""
    return [np.broadcast_to(np.zeros((), _NP_OF[leaf.dtype]), tuple(leaf.shape))
            for leaf in leaves]


def _same_partition(port, ref) -> None:
    assert [(b.index, b.leaf_ids, b.nbytes, b.signature, b.tag) for b in port] == \
        [(b.index, b.leaf_ids, b.nbytes, b.signature, b.tag) for b in ref]


@pytest.mark.parametrize("bucket_bytes", [25 * 1024 * 1024, 1 << 20, 1 << 27])
def test_partition_of_the_sharded_config_is_the_reference(bucket_bytes):
    leaves = [leaf for _, leaf in named_leaves(init_params(TransformerConfig(**SHARDED), 0,
                                                           device="meta"))]
    port = bucketing.partition_buckets(leaves, bucket_bytes)
    _same_partition(port, ref_bucketing.partition_buckets(_ref_leaves(leaves), bucket_bytes))
    assert sorted(i for b in port for i in b.leaf_ids) == list(range(len(leaves)))
    assert port[0].leaf_ids[0] == len(leaves) - 1  # the last leaves fly first


def test_partition_of_mixed_leaves_is_the_reference():
    leaves = [torch.zeros(37, 5), torch.zeros(11, dtype=torch.float16), torch.tensor(1.5),
              torch.zeros(0), torch.zeros(3, 4, dtype=torch.int32),
              torch.zeros(64, dtype=torch.bfloat16), torch.zeros(9)]
    for bucket_bytes in (1, 128, 256, 4096):
        _same_partition(bucketing.partition_buckets(leaves, bucket_bytes),
                        ref_bucketing.partition_buckets(_ref_leaves(leaves), bucket_bytes))
    with pytest.raises(ValueError, match="bucket_bytes must be positive"):
        bucketing.partition_buckets(leaves, 0)


def test_segments_are_the_reference():
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((6, 7)).astype(np.float32),
              rng.standard_normal(5).astype(np.float16), np.float32(2.5),
              rng.standard_normal(0).astype(np.float32)]
    tensors = [torch.from_numpy(np.array(a)) for a in arrays]
    for port_b, ref_b in zip(bucketing.partition_buckets(tensors, 64),
                             ref_bucketing.partition_buckets(arrays, 64)):
        want = ref_bucketing.gather_segment(arrays, ref_b)
        got = bucketing.gather_segment(tensors, port_b)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(bucketing.gather_segment(arrays, port_b), want)
        back, ref_back = (bucketing.scatter_segment(got * 3, tensors, port_b),
                          ref_bucketing.scatter_segment(want * 3, arrays, ref_b))
        assert back.keys() == ref_back.keys()
        for i in back:
            assert back[i].dtype == tensors[i].dtype
            assert np.array_equal(back[i].numpy(), ref_back[i])
    too_long = torch.zeros(sum(bucketing.leaf_size(tensors[i]) for i in port_b.leaf_ids) + 3)
    with pytest.raises(ValueError, match="segment has"):
        bucketing.scatter_segment(too_long, tensors, port_b)


class _Ctx:
    world_rank = 0
    node_id = "n"
    dataset_shards: dict = {}


def test_step_stats_comm_exposed_phase():
    """When a step records comm_exposed, only the exposed seconds come out
    of compute; collective_s keeps the whole wire time."""
    step_stats.activate()
    try:
        rec = step_stats.StepRecorder(_Ctx())
        step_stats.record_phase("collective", 0.2)
        step_stats.record_phase("comm_exposed", 0.04)
        time.sleep(0.3)
        out = rec.on_report({})
        assert out["collective_s"] == pytest.approx(0.2)
        assert out["comm_exposed_s"] == pytest.approx(0.04)
        assert out["compute_s"] >= out["wall_s"] - 0.04 - 0.05
    finally:
        step_stats.deactivate()


@pytest.fixture(scope="module")
def rings():
    """Two 2-member CPU ring gangs: one plain, one whose group's config
    asks for the overlap."""
    plain = WorkerGang(2, use_gpu=False, backend="ring")
    overlapped = WorkerGang(2, use_gpu=False, backend="ring",
                            collective_config=CollectiveConfig(overlap=True, bucket_bytes=256))
    yield plain, overlapped
    plain.shutdown()
    overlapped.shutdown()


def _grads(rank: int) -> dict:
    rng = np.random.default_rng(50 + rank)
    return {"w": torch.from_numpy(rng.standard_normal((37, 5)).astype(np.float32)),
            "aux": torch.from_numpy(rng.standard_normal(11).astype(np.float32)),
            "scalar": torch.tensor(rank + 1.5),
            "empty": torch.zeros(0),
            "half": torch.from_numpy(rng.standard_normal(9).astype(np.float32)).bfloat16()}


def _mono_and_overlapped(ctx):
    from ray_tpu_torch.train import torch_utils

    grads = _grads(ctx.rank)
    mono = torch_utils.sync_gradients_sharded(grads, ctx.group_name, overlap=False)
    handle = torch_utils.begin_gradient_sync(grads, ctx.group_name, bucket_bytes=64)
    over = handle.result()
    inline = torch_utils.sync_gradients_sharded(grads, ctx.group_name, overlap=True,
                                                bucket_bytes=64)
    return ({k: v.float().numpy() for k, v in mono.items()},
            {k: v.float().numpy() for k, v in over.items()},
            {k: v.float().numpy() for k, v in inline.items()},
            dict(handle.stats), {k: str(v.dtype) for k, v in over.items()})


def test_overlapped_sync_is_bitwise_the_monolithic_one(rings):
    """2-rank ring sums are two-operand adds: bucketing cannot change them."""
    results = rings[0].run(_mono_and_overlapped, timeout=120)
    for mono, over, inline, stats, dtypes in results:
        for key in mono:
            assert np.array_equal(mono[key], over[key]) and np.array_equal(mono[key], inline[key])
        assert stats["buckets"] > 1 and stats["collective_s"] > 0.0
        assert stats["comm_exposed_s"] >= 0.0
        assert dtypes["half"] == "torch.bfloat16" and dtypes["w"] == "torch.float32"
    for key in results[0][0]:
        assert np.array_equal(results[0][1][key], results[1][1][key])
    np.testing.assert_allclose(results[0][0]["scalar"], 2.0)  # mean(1.5, 2.5)


def _routed(ctx):
    from ray_tpu_torch.train import torch_utils
    from ray_tpu_torch.util.collective import flight, overlap

    before = {r["rid"] for r in flight.snapshot(4096)}
    out = torch_utils.sync_gradients_sharded({"w": torch.full((8,), ctx.rank + 1.0)},
                                             ctx.group_name)
    kinds = {r["kind"] for r in flight.snapshot(4096) if r["rid"] not in before}
    return out["w"].tolist(), overlap.supports_overlap(ctx.collective()), sorted(kinds)


def test_overlap_config_routes_sync_gradients_sharded(rings):
    plain, overlapped = rings
    for gang, launched in ((overlapped, True), (plain, False)):
        for out, supported, kinds in gang.run(_routed, timeout=120):
            assert out == [1.5] * 8 and supported
            assert ("overlap.launch" in kinds) == launched
            assert ("overlap.fence" in kinds) == launched
            assert "allreduce" in kinds


def _exposed_in_a_session(ctx):
    """Records the phases of a session's step around an overlapped sync."""
    from ray_tpu_torch.train import torch_utils

    step_stats.activate()
    try:
        rec = step_stats.StepRecorder(_Ctx())
        handle = torch_utils.begin_gradient_sync(_grads(ctx.rank), ctx.group_name)
        time.sleep(0.05)  # the rest of a backward
        handle.result()
        return rec.on_report({})
    finally:
        step_stats.deactivate()


def test_comm_exposed_is_recorded(rings):
    for out in rings[1].run(_exposed_in_a_session, timeout=120):
        assert out["collective_s"] > 0.0
        assert 0.0 < out["comm_exposed_s"] <= out["wall_s"]
