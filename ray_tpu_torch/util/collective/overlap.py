"""Asynchronous bucketed allreduce: gradient sync overlapped with other work.

Port of ray_tpu's ``util/collective/overlap.py``, the launch and fence
half of the overlap path (the partition is ``bucketing``). Each bucket's
allreduce runs on a per-group thread pool: the ring underneath waits on
its peers most of the time (acks and mailbox arrivals), so concurrent
buckets interleave their hops, and the caller's thread is free between
``launch`` and ``fence``.

* Each bucket's op still runs through the group's instrumented method on
  its own thread, so the step's total "collective" phase is unchanged:
  the work moved off the critical path, it did not shrink.
* The wall time the caller spends blocked in :meth:`SyncHandle.fence` is
  recorded as the "comm_exposed" phase. A hidden sync shows
  ``comm_exposed_s`` near 0 while ``collective_s`` stays.

Concurrent ring ops are isolated by tag: sequence numbers, mailbox slots
and error-feedback residuals are keyed by (peer, tag) or (tag, step), and
the bucket tags are distinct by construction (``Bucket.tag``). Every rank
derives the same partition, so the launch order agrees, and a rank that
races ahead only fills the slow rank's mailbox.

Only the host-memory backends (``ring``, ``hier``) take tagged concurrent
allreduces; the NCCL groups keep the trainer's own ``async_op`` path.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np
import torch

from ray_tpu_torch.train import step_stats
from ray_tpu_torch.util.collective import bucketing
from ray_tpu_torch.util.collective import flight

# Buckets in flight at once.
_POOL_WORKERS = 8
_pool_lock = threading.Lock()


def _pool(group: Any) -> ThreadPoolExecutor:
    """The group's overlap thread pool, made on first use (one a group)."""
    pool = getattr(group, "_overlap_pool", None)
    if pool is None:
        with _pool_lock:
            pool = getattr(group, "_overlap_pool", None)
            if pool is None:
                pool = ThreadPoolExecutor(
                    max_workers=_POOL_WORKERS,
                    thread_name_prefix=f"overlap-{group.group_name}",
                )
                group._overlap_pool = pool
    return pool


def supports_overlap(group: Any) -> bool:
    """Only the host-memory backends take tagged concurrent allreduces."""
    return getattr(group, "backend_name", "") in ("ring", "hier")


class SyncHandle:
    """An in-flight bucketed sync: one future a bucket, fenced once."""

    def __init__(self, buckets: Sequence[bucketing.Bucket], group: Any = None):
        self.buckets = list(buckets)
        self.futures: list[Future] = []
        self.launched_at = time.perf_counter()
        self.stats: dict[str, float] = {}
        self._group = group

    def fence(self) -> list:
        """Blocks until every bucket's reduction lands. Returns the reduced
        segments in bucket order and records the blocked wall time as the
        "comm_exposed" phase (floored at a tick, so "overlap ran and hid
        everything" differs from "no overlap")."""
        t0 = time.perf_counter()
        g = self._group
        rec = None
        if g is not None:
            # The fence is an in-flight comm op: if a bucket wedges on a
            # pool thread, this record ages past the watchdog's deadline.
            rec = flight.op_started(
                g.group_name, "overlap.fence", f"b{len(self.buckets)}",
                g.rank, g.world_size, backend=getattr(g, "backend_name", ""),
            )
        try:
            # Each bucket's wait is a ``fence.b<i>`` scope, so a straggling
            # bucket is one named slice on a trace.
            results = []
            for i, fut in enumerate(self.futures):
                with step_stats.step_annotation(f"fence.b{i}"):
                    results.append(fut.result())
        except BaseException:
            if rec is not None:
                flight.completed(rec, ok=False)
            raise
        if rec is not None:
            flight.completed(rec)
        exposed = time.perf_counter() - t0
        self.stats = {
            "comm_exposed_s": exposed,
            "collective_s": sum(sec for _, sec in results),
            "buckets": float(len(self.buckets)),
        }
        step_stats.record_phase("comm_exposed", max(exposed, 1e-9))
        return [seg for seg, _ in results]


def launch_bucketed_allreduce(
    group: Any,
    per_device_leaves: Sequence[Sequence[Any]],
    bucket_bytes: int | None = None,
) -> SyncHandle:
    """Partitions gradient leaves into buckets and launches each bucket's
    allreduce asynchronously (bucket 0, the last layers', first).

    ``per_device_leaves`` is a list of leaf lists, one a local device (the
    port's one-device process passes ``[leaves]``); leaves are numpy
    arrays or tensors, a tensor's segment reduced on its device. Returns a
    :class:`SyncHandle`; the SUM-reduced (not averaged) segments come out
    of ``handle.fence()`` in bucket order.
    """
    if not supports_overlap(group):
        raise ValueError(
            f"backend {getattr(group, 'backend_name', '?')!r} has no "
            "tagged-allreduce overlap path (use the default sync)"
        )
    if bucket_bytes is None:
        bucket_bytes = int(
            getattr(group.config, "bucket_bytes", 0)
            or bucketing.DEFAULT_BUCKET_BYTES
        )
    template = per_device_leaves[0]
    buckets = bucketing.partition_buckets(template, bucket_bytes)
    handle = SyncHandle(buckets, group=group)
    pool = _pool(group)
    flight.note(
        group.group_name, "overlap.launch", f"b{len(buckets)}",
        rank=group.rank, world_size=group.world_size,
        nbytes=sum(b.nbytes for b in buckets),
        backend=getattr(group, "backend_name", ""),
    )
    for bucket in buckets:
        segments = [
            bucketing.gather_segment(leaves, bucket)
            for leaves in per_device_leaves
        ]
        handle.futures.append(
            pool.submit(_reduce_bucket, group, bucket, segments)
        )
    return handle


def _size(segment) -> int:
    return segment.numel() if isinstance(segment, torch.Tensor) else segment.size


def _reduce_bucket(group: Any, bucket: bucketing.Bucket, segments: list) -> tuple:
    """One bucket's SUM across the local devices and the gang, on a pool
    thread; returns (reduced segment, op seconds)."""
    t0 = time.perf_counter()
    if _size(segments[0]) == 0:
        return segments[0], 0.0
    if len(segments) > 1 and hasattr(group, "allreduce_sharded"):
        out = group.allreduce_sharded(segments, tag=bucket.tag)
    else:
        if len(segments) == 1:
            local = segments[0]
        elif isinstance(segments[0], torch.Tensor):
            local = torch.stack(segments).sum(dim=0)
        else:
            local = np.sum(np.stack(segments), axis=0)
        if group.world_size > 1:
            out = group.allreduce(local, tag=bucket.tag)
        else:
            out = local
    return out, time.perf_counter() - t0
