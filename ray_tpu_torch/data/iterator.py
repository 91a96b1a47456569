"""DataIterator: consumption-side streaming with prefetch and resumable state.

Port of ray_tpu's ``data/iterator.py``: ``DataIterator.iter_batches``
(threaded block prefetch, format conversion) and streaming_split's
per-consumer iterators. Batches come out as numpy dicts (default), pandas,
arrow, or torch CPU tensors (``iter_torch_batches`` yields host tensors, as
the reference does: the training loop moves them to its card).

Resume-exact ingest: split iterators are *span-based* — a shard
is an ordered list of ``[block_idx, start, stop]`` spans over the global
block list — and expose ``state_dict()`` / ``load_state_dict()`` carrying
(epoch, spans, rows-consumed-this-epoch). ``streaming_split(...,
resume_from=...)`` rebuilds shards from a set of per-rank states captured
at a checkpoint, subtracting consumed rows and re-partitioning the
*remaining* sample space across the new world size, so a restart at any
world size replays no committed sample and drops none. The state's format
is the reference's, so an ingest record is interchangeable between the
packages.

A split-mode iterator pickles with stdlib pickle (block refs and spans, no
factory and no thread): the trainer hands one to each gang member, whose
process reads the blocks from the splitting process's store files. The
reference's ``_SplitCoordinator`` actor is defined there and never used;
it is left out.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np

from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.data.block import BlockAccessor, concat, num_rows, slice_block, take
from ray_tpu_torch.data._internal.map_fn import BLOCK_FORMAT, batch_blocks, format_batch


def _span_slice(block, start: int, stop: Optional[int]):
    """Slice rows [start, stop) out of a block (stop=None: to the end)."""
    block = BlockAccessor.for_block(block).block
    rows = num_rows(block)
    if start == 0 and (stop is None or stop >= rows):
        return block
    end = rows if stop is None else min(stop, rows)
    return slice_block(block, start, end)


class DataIterator:
    def __init__(self, ref_iter_factory=None, owner_name: str = "dataset",
                 stats=None, *, block_refs: list | None = None,
                 spans: list | None = None):
        """Two construction modes:

        * ``ref_iter_factory``: () -> iterator of block refs (fresh each
          epoch). Streaming pipelines; position is not resumable.
        * ``block_refs`` + ``spans``: a materialized global block list plus
          this consumer's ordered [block_idx, start, stop] spans — the
          split-shard mode, which supports state_dict/load_state_dict.
        """
        if (ref_iter_factory is None) == (block_refs is None):
            raise ValueError(
                "exactly one of ref_iter_factory or block_refs is required"
            )
        self._factory = ref_iter_factory
        self._block_refs = block_refs
        self._base_spans = [list(s) for s in spans] if spans is not None else None
        self._owner_name = owner_name
        self._stats = stats
        self._fetch_wait_s = 0.0
        # Resume position: epoch counter, spans for the *current* pass
        # (differs from _base_spans only on the first pass after a resume),
        # rows to skip at the head of the current pass, and rows delivered
        # so far in the in-flight pass (counted at batch-yield time).
        self._epoch = 0
        self._resume_spans: list | None = None
        self._resume_skip = 0
        self._pass_rows = 0
        self._pass_active = False

    @property
    def fetch_wait_s(self) -> float:
        """Cumulative seconds the consumer spent blocked on producers: the
        flight recorder's data-wait clock (``train.step_stats``): each
        ``train.report()`` interval attributes the delta to the step's
        ``data_wait_s`` phase."""
        return self._fetch_wait_s

    # -- resumable-ingest state ----------------------------------------
    @property
    def supports_state(self) -> bool:
        return self._base_spans is not None

    def state_dict(self) -> dict:
        """Position snapshot: {"epoch", "rows", "spans"}.

        ``rows`` counts rows *delivered to the caller* in the current epoch
        (a partially-assembled carry batch is not counted — those rows were
        never seen by user code and will be re-read on resume). ``spans``
        are the spans of the in-flight pass, so a state taken mid-resume
        composes: resuming a resumed run subtracts from the right base.
        """
        if self._resume_spans is not None:
            spans = self._resume_spans
            rows = self._pass_rows if self._pass_active else self._resume_skip
        else:
            spans = self._base_spans
            rows = self._pass_rows
        return {
            "epoch": self._epoch,
            "rows": rows,
            "spans": [list(s) for s in spans] if spans is not None else None,
        }

    def load_state_dict(self, state: dict) -> None:
        """Resume this iterator at a position captured by ``state_dict()``
        (same world size — for cross-size resumes go through
        ``streaming_split(..., resume_from=...)``)."""
        if not self.supports_state:
            raise ValueError(
                f"{self._owner_name}: streaming (factory-based) iterators "
                "cannot load ingest state; materialize + split instead"
            )
        if state.get("spans") is None:
            raise ValueError("state has no spans; not a split-shard state")
        self._epoch = int(state.get("epoch", 0))
        self._resume_spans = [list(s) for s in state["spans"]]
        self._resume_skip = int(state.get("rows", 0))
        self._pass_rows = 0
        self._pass_active = False

    def _block_iter(self, prefetch_blocks: int) -> Iterator:
        """Fetch blocks with a prefetch thread (depth = prefetch_blocks+1)."""
        if self._factory is not None:
            refs = self._factory()
            spans = None
        else:
            # The resume overlay (cleared by _end_pass when the in-flight
            # epoch completes) wins over the steady-state base spans.
            if self._resume_spans is not None:
                spans = self._resume_spans
                skip = self._resume_skip
            else:
                spans = self._base_spans
                skip = 0
            refs = None
        q: queue.Queue = queue.Queue(maxsize=max(1, prefetch_blocks + 1))
        _DONE = object()

        def producer():
            try:
                if spans is None:
                    for ref in refs:
                        q.put(local_tasks.get(ref))
                else:
                    remaining_skip = skip
                    for block_idx, start, stop in spans:
                        block = _span_slice(
                            local_tasks.get(self._block_refs[block_idx]),
                            start, stop,
                        )
                        rows = num_rows(block)
                        if remaining_skip:
                            if rows <= remaining_skip:
                                remaining_skip -= rows
                                continue
                            block = slice_block(block, remaining_skip, rows)
                            remaining_skip = 0
                        if num_rows(block):
                            q.put(block)
            except BaseException as exc:
                q.put(exc)
                return
            q.put(_DONE)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        import time as _time

        while True:
            t0 = _time.perf_counter()
            item = q.get()
            # Time truly blocked on producers (vs local batching/format).
            self._fetch_wait_s += _time.perf_counter() - t0
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        """Yields formatted batches; when the owning Dataset tracks stats,
        records wait-on-producer vs in-user-code time (the "is my input
        pipeline the bottleneck" split of ds.stats())."""
        inner = self._iter_batches_impl(**kwargs)
        if self._stats is None:
            yield from inner
            return
        import time as _time

        produce_s = user_s = 0.0
        batches = 0
        last_yield_end = None
        self._fetch_wait_s = 0.0
        try:
            while True:
                resume = _time.perf_counter()
                if last_yield_end is not None:
                    user_s += resume - last_yield_end
                try:
                    batch = next(inner)
                except StopIteration:
                    break
                produce_s += _time.perf_counter() - resume
                batches += 1
                yield batch
                last_yield_end = _time.perf_counter()
        finally:
            # Split production time into blocked-on-producers (block fetch
            # wait, measured in _block_iter) vs local batching/formatting.
            wait_s = min(self._fetch_wait_s, produce_s)
            self._stats.record_iter(
                wait_s, user_s, batches, local_s=produce_s - wait_s
            )

    def _begin_pass(self) -> None:
        self._pass_active = True
        # Skipped rows count as already delivered this epoch so that a
        # state taken mid-resume records the absolute epoch position.
        self._pass_rows = (
            self._resume_skip if self._resume_spans is not None else 0
        )

    def _end_pass(self) -> None:
        """A pass ran to exhaustion: advance the epoch and drop any resume
        overlay — the next pass re-reads this shard's full base spans."""
        self._pass_active = False
        self._epoch += 1
        self._resume_spans = None
        self._resume_skip = 0
        self._pass_rows = 0

    def _iter_batches_impl(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        prefetch_blocks: int = 2,
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        self._begin_pass()
        carry = None
        shuffle_rng = (
            np.random.default_rng(local_shuffle_seed)
            if local_shuffle_buffer_size
            else None
        )
        buffer = []
        buffered_rows = 0

        def emit(block):
            nonlocal carry
            for batch in batch_blocks(block, batch_size):
                if batch_size and num_rows(batch) < batch_size:
                    carry = batch
                    return
                formatted = format_batch(batch, batch_format)
                self._pass_rows += num_rows(batch)
                yield formatted

        for block in self._block_iter(prefetch_blocks):
            block = BlockAccessor.for_block(block).block
            if carry is not None:
                block = concat([carry, block])
                carry = None
            if shuffle_rng is not None:
                buffer.append(block)
                buffered_rows += num_rows(block)
                if buffered_rows < local_shuffle_buffer_size:
                    continue
                merged = concat(buffer)
                buffer, buffered_rows = [], 0
                block = take(merged, shuffle_rng.permutation(num_rows(merged)))
            yield from emit(block)
        if buffer:
            merged = concat(buffer)
            block = take(merged, shuffle_rng.permutation(num_rows(merged)))
            if carry is not None:
                block = concat([carry, block])
                carry = None
            yield from emit(block)
        if carry is not None and (not drop_last or batch_size is None):
            formatted = format_batch(carry, batch_format)
            self._pass_rows += num_rows(carry)
            yield formatted
        self._end_pass()

    def iter_rows(self) -> Iterator[dict]:
        for block in self.iter_batches(batch_size=None, batch_format=BLOCK_FORMAT):
            yield from BlockAccessor(block).iter_rows()

    def iter_torch_batches(
        self, *, batch_size: Optional[int] = 256, dtypes=None, **kwargs
    ) -> Iterator[dict]:
        import torch

        for batch in self.iter_batches(
            batch_size=batch_size, batch_format="numpy", **kwargs
        ):
            out = {}
            for key, value in batch.items():
                # A batch may be a read-only view of the store's mapping.
                if isinstance(value, np.ndarray) and not value.flags.writeable:
                    value = value.copy()
                tensor = torch.as_tensor(value)
                if dtypes is not None:
                    want = dtypes.get(key) if isinstance(dtypes, dict) else dtypes
                    if want is not None:
                        tensor = tensor.to(want)
                out[key] = tensor
            yield out

    def materialize_refs(self) -> list:
        if self._factory is not None:
            return list(self._factory())
        # Span mode: materialize each span as its own (sliced) block ref.
        out = []
        for block_idx, start, stop in self._base_spans:
            ref = self._block_refs[block_idx]
            if start == 0 and stop is None:
                out.append(ref)
            else:
                out.append(local_tasks.put(_span_slice(local_tasks.get(ref), start, stop)))
        return out


def _block_num_rows(block_refs: list, needed: set) -> dict[int, int]:
    """Row counts for the given block indices (one remote round trip)."""
    from ray_tpu_torch.data._internal.streaming_executor import _num_rows

    idxs = sorted(needed)
    counts = local_tasks.get([_num_rows.remote(block_refs[i]) for i in idxs])
    return dict(zip(idxs, counts))


def _remaining_spans(state: dict, nrows: dict[int, int]) -> list:
    """Subtract a rank's consumed-row count from its spans, returning the
    fragments it had not yet delivered."""
    rows = int(state.get("rows", 0))
    out = []
    for block_idx, start, stop in state["spans"]:
        end = nrows[block_idx] if stop is None else min(stop, nrows[block_idx])
        span_len = max(0, end - start)
        if rows >= span_len:
            rows -= span_len
            continue
        out.append([block_idx, start + rows, end])
        rows = 0
    return out


def streaming_split(
    block_refs: list, n: int, *, resume_from: dict | None = None
) -> list[DataIterator]:
    """n independent DataIterators over a disjoint partition of blocks.

    ``resume_from`` = ``{"world_size": W, "per_rank": [state, ...]}`` (the
    per-rank ``state_dict()`` snapshots stamped into a committed
    checkpoint) resumes mid-epoch at *any* new world size n: every rank's
    un-consumed span fragments are pooled, re-partitioned across the n new
    ranks for the in-flight epoch, and subsequent epochs use the fresh
    n-way split. Rows a rank consumed after the snapshot are re-delivered
    (duplication bounded to the last uncommitted round); nothing is
    dropped.
    """
    block_refs = list(block_refs)
    iterators = []
    base = [
        [[i, 0, None] for i in range(rank, len(block_refs), n)]
        for rank in range(n)
    ]
    resume_per_rank: list | None = None
    epoch0 = 0
    if resume_from and resume_from.get("per_rank"):
        states = [
            s for s in resume_from["per_rank"]
            if s and s.get("spans") is not None
        ]
        if states:
            epoch0 = min(int(s.get("epoch", 0)) for s in states)
            needed = {
                span[0] for s in states for span in s["spans"]
            }
            nrows = _block_num_rows(block_refs, needed) if needed else {}
            fragments: list = []
            for s in states:
                fragments.extend(_remaining_spans(s, nrows))
            fragments.sort(key=lambda f: (f[0], f[1]))
            resume_per_rank = [fragments[rank::n] for rank in range(n)]
    for rank in range(n):
        it = DataIterator(
            owner_name=f"split[{rank}]",
            block_refs=block_refs,
            spans=base[rank],
        )
        if resume_per_rank is not None:
            it._epoch = epoch0
            it._resume_spans = resume_per_rank[rank]
            it._resume_skip = 0
        iterators.append(it)
    return iterators
