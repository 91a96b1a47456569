"""Slot-based continuous-batch state.

The port's copy of ray_tpu's ``serve/llm/batch.py``. The running decode
batch is a fixed array of slots. A sequence occupies one slot from
admission to completion; completed sequences are evicted every iteration
and their slot re-admitted the very next one, where ``serve/batching.py``
forms a new batch only at batch boundaries. The active-slot count rounds
up to a configured bucket, so the decode step sees a bounded set of padded
shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from ray_tpu_torch.serve._common import Deadline


@dataclass
class SequenceState:
    """One in-flight sequence: identity, progress, and its KV pages."""

    request_id: str
    prompt_tokens: List[int]
    max_tokens: int
    session_id: str = ""
    model_id: str = ""
    generated: List[int] = field(default_factory=list)
    # Block ids in the decode replica's KVBlockPool (allocated at
    # admission, freed at eviction).
    kv_blocks: List[int] = field(default_factory=list)
    # Decoded prefill KV, held only between arrival and KV-pool allocation
    # (dropped once paged in).
    kv_data: Any = None
    deadline: Deadline = field(default_factory=Deadline.never)
    # Completion surfaces: a future (unary) or an output channel
    # (streaming); the engine completes exactly one of them.
    future: Any = None
    out_chan: Any = None
    admitted_at: float = 0.0

    # -- observability --------------------------------------------------
    # Trace context captured at request entry and the deterministic
    # seq_trace_sample decision, stable across replays.
    trace_ctx: Any = None
    sampled: bool = False
    # Tokens the client already holds from a replica that died: the
    # ledger charges exactly this many to replay_discarded.
    resume_from: int = 0
    # Monotonic timestamps of the sequence's lifecycle: request entry,
    # slot admission, first token; ``token_times`` collects every emission.
    enqueued_at: float = 0.0
    slot_admitted_at: float = 0.0
    first_token_at: float = 0.0
    token_times: List[float] = field(default_factory=list)
    # Upstream phase durations measured by the decode deployment.
    prefill_s: float = 0.0
    kv_transfer_s: float = 0.0

    def done(self) -> bool:
        return len(self.generated) >= self.max_tokens


class SlotBatch:
    """Fixed-capacity slot table and bucketed padded-shape selection."""

    def __init__(self, max_slots: int, buckets=()):
        self.max_slots = int(max_slots)
        # Keep only buckets the slot table can fill, and always close the
        # ladder with max_slots itself.
        kept = sorted(int(b) for b in buckets if 0 < int(b) <= self.max_slots)
        if not kept or kept[-1] < self.max_slots:
            kept.append(self.max_slots)
        self.buckets = tuple(kept)
        self.slots: List[Optional[SequenceState]] = [None] * self.max_slots
        self._free: List[int] = list(range(self.max_slots - 1, -1, -1))

    def free_count(self) -> int:
        return len(self._free)

    def occupancy(self) -> int:
        return self.max_slots - len(self._free)

    def admit(self, seq: SequenceState) -> int:
        if not self._free:
            raise RuntimeError("no free slot")
        idx = self._free.pop()
        self.slots[idx] = seq
        return idx

    def evict(self, idx: int) -> Optional[SequenceState]:
        seq = self.slots[idx]
        if seq is not None:
            self.slots[idx] = None
            self._free.append(idx)
        return seq

    def active(self) -> List[tuple]:
        """(slot index, sequence) for every occupied slot, in slot order, so
        the padded batch layout is stable between iterations."""
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket covering ``n`` active slots."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]
