"""The port's @batch decorator (ray_tpu_torch.serve.batching) on the CPU:
bucket padding and stripping, per-item results equal to an unbatched
forward of the tiny model, the bucket-size check and deadline expiry."""

import asyncio

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.serve import batching
from ray_tpu_torch.serve._common import (
    Deadline, DeadlineExceededError, reset_current_deadline, set_current_deadline,
)


def test_bucket_padding_is_stripped_from_results():
    seen = []

    class Doubler:
        @batching.batch(max_batch_size=8, batch_wait_timeout_s=0.01, bucket_sizes=[1, 4, 8])
        async def __call__(self, items):
            seen.append(list(items))
            return [2 * x for x in items]

    async def main():
        d = Doubler()
        return await asyncio.gather(*(d(i) for i in range(3)))

    assert asyncio.run(main()) == [0, 2, 4]
    # 3 requests flushed by the timeout, padded to bucket 4 with the last one.
    assert seen == [[0, 1, 2, 2]]
    assert "batch:4" in batching.warm_shapes()


def test_full_batch_flushes_without_waiting():
    sizes = []

    @batching.batch(max_batch_size=4, batch_wait_timeout_s=30.0)
    async def echo(items):
        sizes.append(len(items))
        return items

    async def main():
        return await asyncio.wait_for(asyncio.gather(*(echo(i) for i in range(8))), 5)

    assert asyncio.run(main()) == list(range(8))
    assert sizes == [4, 4]


def test_largest_bucket_below_max_batch_size_raises():
    @batching.batch(max_batch_size=8, bucket_sizes=[1, 4])
    async def fn(items):
        return items

    async def main():
        await fn(1)

    with pytest.raises(ValueError, match="largest bucket"):
        asyncio.run(main())


def test_expired_deadline_fails_at_flush():
    calls = []

    @batching.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
    async def fn(items):
        calls.append(list(items))
        return items

    async def submit(item, budget):
        token = set_current_deadline(Deadline.after(budget))
        try:
            return await fn(item)
        finally:
            reset_current_deadline(token)

    async def main():
        return await asyncio.gather(submit("late", 0.0), submit("fresh", 60.0),
                                    return_exceptions=True)

    late, fresh = asyncio.run(main())
    assert isinstance(late, DeadlineExceededError) and isinstance(late, TimeoutError)
    assert fresh == "fresh"
    assert calls == [["fresh"]]


def test_batch_error_reaches_every_caller():
    @batching.batch(max_batch_size=2, batch_wait_timeout_s=0.01)
    async def broken(items):
        return items[:1]  # one result for two requests

    async def main():
        return await asyncio.gather(broken(1), broken(2), return_exceptions=True)

    results = asyncio.run(main())
    assert all(isinstance(r, ValueError) for r in results)


def test_queue_stats_count_real_and_padded_items():
    @batching.batch(max_batch_size=8, batch_wait_timeout_s=0.01, bucket_sizes=[8])
    async def fn(items):
        return items

    async def main():
        await asyncio.gather(*(fn(i) for i in range(5)))
        return batching.queue_stats()

    stats = asyncio.run(main())
    assert stats["queue_depth"] == 0
    assert stats["items_real"] >= 5 and stats["items_padded"] >= 8
    assert stats["batch_occupancy"] is not None


def test_batched_forward_matches_unbatched_forward():
    """An encoder deployment in the shape of release/serve_bert_http.py:
    requests padded to buckets (1, 4, 8), each answered with its own
    last-position logits."""
    config = pt.TransformerConfig.tiny()
    params = pt.init_params(config, seed=0, device="cpu")
    seq = 16

    class Encoder:
        @batching.batch(max_batch_size=8, batch_wait_timeout_s=0.005, bucket_sizes=[1, 4, 8])
        async def __call__(self, bodies):
            tokens = torch.zeros(len(bodies), seq, dtype=torch.int64)
            for i, body in enumerate(bodies):
                tokens[i] = torch.as_tensor(body["token_ids"])
            with torch.inference_mode():
                logits = pt.forward(params, tokens, config)
            return [row for row in logits[:, -1]]

    rng = np.random.default_rng(5)
    requests = [{"token_ids": rng.integers(0, 256, seq).tolist()} for _ in range(6)]

    async def main():
        enc = Encoder()
        return await asyncio.gather(*(enc(body) for body in requests))

    answers = asyncio.run(main())
    for body, answer in zip(requests, answers):
        alone = pt.forward(params, torch.tensor([body["token_ids"]]), config)[0, -1]
        # Rows of a batch are independent; only the matmul blocking differs.
        assert float((answer - alone).abs().max()) < 1e-4
