"""Paged KV-block pool, one per decode replica.

The port's copy of ray_tpu's ``serve/llm/kv.py``: a fixed arena of
fixed-size KV blocks. Sequences allocate whole blocks at admission and
free them at eviction, so fragmentation is impossible by construction and
the pool's headroom is one number, the free-block fraction, which feeds
the autoscaler's ``kv_headroom_min``.

The arena is a float32 tensor on an explicit ``device``: a decode replica
placed on a card holds it in the card's memory, the headroom the reference
accounts for. ``alloc``, ``release``, ``blocks_needed`` and the free list
are the reference's. ``write`` and ``read`` work on the arena's device and
never wait for it: the decode loop reads every active slot's pages each
iteration, and a wait there would stall the engine. The reference's
``export_gauges`` (``util/metrics``) is left out until the port has
metrics (ROADMAP Queue A item 14b-ii).
"""

from __future__ import annotations

from typing import List, Optional

import torch


class KVBlockPool:
    """Fixed arena of ``num_blocks`` blocks of ``block_tokens * kv_dim``
    float32 each on ``device``. Not thread-safe: the decode engine is the
    only caller and runs on one event loop."""

    def __init__(self, num_blocks: int, block_tokens: int, kv_dim: int, *,
                 device="cuda", deployment: str = "", replica_id: str = ""):
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self.kv_dim = int(kv_dim)
        self.block_elems = self.block_tokens * self.kv_dim
        self.device = torch.device(device)
        self._arena = torch.zeros((self.num_blocks, self.block_elems), dtype=torch.float32,
                                  device=self.device)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._deployment = deployment
        self._replica_id = replica_id

    # -- accounting -----------------------------------------------------
    def used(self) -> int:
        return self.num_blocks - len(self._free)

    def free(self) -> int:
        return len(self._free)

    def free_frac(self) -> float:
        return len(self._free) / max(1, self.num_blocks)

    def blocks_needed(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.block_tokens))

    # -- alloc/free -----------------------------------------------------
    def alloc(self, n_blocks: int) -> Optional[List[int]]:
        """n block ids, or None when the pool can't cover the request: the
        engine defers the sequence rather than partially allocating."""
        if n_blocks > len(self._free):
            return None
        return [self._free.pop() for _ in range(n_blocks)]

    def release(self, block_ids: List[int]) -> None:
        for bid in block_ids:
            self._arena[bid].zero_()
            self._free.append(bid)

    # -- data -----------------------------------------------------------
    def write(self, block_ids: List[int], kv) -> None:
        """Pages a sequence's prefill KV ((n_tokens, kv_dim) float32, a
        tensor on the arena's device or anything ``torch.as_tensor`` takes)
        into its allocated blocks, zero-padding the tail block."""
        flat = torch.as_tensor(kv, dtype=torch.float32).to(self.device).reshape(-1)
        for i, bid in enumerate(block_ids):
            chunk = flat[i * self.block_elems:(i + 1) * self.block_elems]
            n = chunk.numel()
            self._arena[bid, :n].copy_(chunk)
            if n < self.block_elems:
                self._arena[bid, n:].zero_()

    def read(self, block_ids: List[int]) -> torch.Tensor:
        """The sequence's KV pages, stacked (n_blocks, block_elems) on the
        arena's device: a copy, as the reference's fancy index is."""
        return torch.stack([self._arena[bid] for bid in block_ids])
