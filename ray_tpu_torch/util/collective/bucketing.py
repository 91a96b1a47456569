"""Size-targeted gradient buckets for the overlapped allreduce.

Port of ray_tpu's ``util/collective/bucketing.py``: the partition of a
gradient's leaves into buckets of about ``bucket_bytes`` of f32, and each
bucket's flat segment (gather and scatter). The launch and the fence live
in ``overlap``.

* Every leaf lands in exactly one bucket; a bucket's size is 4 bytes an
  element (the reduction wire is f32), whatever the leaves' dtypes.
* Leaves are packed from the END of the list: backward makes the last
  layers' gradients first, so bucket 0 is the first to launch.
* The partition is a pure function of the leaf shapes, dtypes and
  ``bucket_bytes``, so every rank derives the same buckets and their tags
  pair up with no negotiation.
* Each bucket's ``signature`` hashes its leaves' (index, shape, dtype),
  the dtype as numpy writes it (``dtype.str``: bf16 is "<V2" there, as
  ml_dtypes' bfloat16), so a tag equals the reference's for the same
  leaves, and a repartition changes the tag and starts the quantized
  ring's error-feedback residuals afresh.

Leaves may be numpy arrays or tensors; a tensor's segment stays on its
device.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence

import numpy as np
import torch

# ~25MB of f32 per bucket: large enough that ring-hop latency amortizes,
# small enough that several buckets are in flight during one backward.
DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024

# numpy's dtype.str of the torch dtypes numpy has no type for (ml_dtypes'
# bfloat16 and float8_e4m3fn are void types of their width there).
_VOID_DTYPES = {torch.bfloat16: "<V2", getattr(torch, "float8_e4m3fn", None): "<V1"}


def leaf_size(leaf: Any) -> int:
    """Element count of a leaf; scalars count 1, zero-size arrays 0."""
    return int(np.prod(tuple(np.shape(leaf)), dtype=np.int64))


def dtype_str(leaf: Any) -> str:
    """The leaf's dtype as numpy's ``dtype.str`` names it."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype in _VOID_DTYPES:
            return _VOID_DTYPES[leaf.dtype]
        return np.dtype(torch.empty(0, dtype=leaf.dtype).numpy().dtype).str
    return np.asarray(leaf).dtype.str


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One bucket of the partition: which leaves, in launch order."""

    index: int
    leaf_ids: tuple[int, ...]  # indices into the flattened leaf list
    nbytes: int                # f32 wire bytes of the whole bucket
    signature: str             # structure hash, part of the wire tag

    @property
    def tag(self) -> str:
        """The per-bucket collective tag."""
        return f"__gb{self.index}:{self.signature}"


def _signature(leaves: Sequence[Any], leaf_ids: Sequence[int]) -> str:
    meta = tuple(
        (i, tuple(int(d) for d in np.shape(leaves[i])), dtype_str(leaves[i]))
        for i in leaf_ids
    )
    return hashlib.blake2s(repr(meta).encode(), digest_size=4).hexdigest()


def partition_buckets(
    leaves: Sequence[Any], bucket_bytes: int = DEFAULT_BUCKET_BYTES
) -> list[Bucket]:
    """Greedy size-targeted partition of ``leaves`` into buckets: walks the
    leaves in reverse and closes a bucket once it reaches ``bucket_bytes``
    of f32 payload. A leaf larger than ``bucket_bytes`` gets a bucket of
    its own (the ring chunks it)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    buckets: list[Bucket] = []
    current: list[int] = []
    current_bytes = 0

    def _flush() -> None:
        nonlocal current, current_bytes
        if not current:
            return
        buckets.append(
            Bucket(
                index=len(buckets),
                leaf_ids=tuple(current),
                nbytes=current_bytes,
                signature=_signature(leaves, current),
            )
        )
        current, current_bytes = [], 0

    for i in range(len(leaves) - 1, -1, -1):
        current.append(i)
        current_bytes += leaf_size(leaves[i]) * 4  # f32 wire
        if current_bytes >= bucket_bytes:
            _flush()
    _flush()
    return buckets


def gather_segment(leaves: Sequence[Any], bucket: Bucket):
    """A bucket's leaves as one flat f32 segment: a tensor on the leaves'
    device for tensor leaves, numpy otherwise."""
    if leaves and isinstance(leaves[bucket.leaf_ids[0]], torch.Tensor):
        return torch.cat([leaves[i].detach().reshape(-1).to(torch.float32)
                          for i in bucket.leaf_ids])
    parts = [np.asarray(leaves[i], np.float32).ravel() for i in bucket.leaf_ids]
    if not parts:
        return np.zeros(0, np.float32)
    return np.concatenate(parts)


def scatter_segment(segment, leaves: Sequence[Any], bucket: Bucket) -> dict:
    """Split a reduced flat segment back into per-leaf arrays (or tensors)
    with the original shapes and dtypes. Returns {leaf_id: array}."""
    out: dict = {}
    offset = 0
    n = segment.numel() if isinstance(segment, torch.Tensor) else segment.size
    for i in bucket.leaf_ids:
        shape = tuple(np.shape(leaves[i]))
        size = leaf_size(leaves[i])
        piece = segment[offset:offset + size].reshape(shape)
        if isinstance(segment, torch.Tensor):
            out[i] = piece.to(leaves[i].dtype)
        else:
            out[i] = piece.astype(np.asarray(leaves[i]).dtype)
        offset += size
    if offset != n:
        raise ValueError(
            f"bucket {bucket.index}: segment has {n} elements, leaves expect {offset}"
        )
    return out
