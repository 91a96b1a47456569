"""DecodeEngine: the resident continuous-batching decode loop.

The port's copy of ray_tpu's ``serve/llm/engine.py``: one resident loop
per decode replica, an asyncio task on the replica's event loop.
Admission is a bounded ``LocalChannel`` (``dag/channels.py``), and so is
each streaming sequence's token stream. Every iteration:

1. admit newly arrived sequences into free slots (continuous batching: no
   batch boundaries),
2. page their prefill KV into the paged block pool (on the pool's device),
3. evict sequences whose deadline expired,
4. run ONE decode step over the active slots at the covering padded
   bucket,
5. append or stream tokens and evict completed sequences (their slots are
   free for step 1 of the next iteration),
6. note the KV pool's headroom on the sequence timeline.

The steady state is in-process work: channel ops, pool arithmetic, the
model step. No call to the serve controller in an iteration.

Before each decode step an armed chaos failpoint ``serve.llm.decode_iter``
ends the replica (the handle's death retry re-prefills on a sibling). With
tracing on, an iteration with a sampled sequence active is a
``decode.iter`` span under the first such sequence's context, and a
sampled sequence's token events carry its trace id (``tr``) and ride its
stream channel in the trace envelope. Each iteration sets the
``util/metrics`` gauges of slot occupancy and KV blocks used and free and
counts the tokens it issued; each token observes TTFT (its sequence's
first) or TPOT, and a sequence's end counts its tokens by ledger class.
"""

from __future__ import annotations

import asyncio
import os
import logging
import time
import uuid

from ray_tpu_torch._private import chaos
from ray_tpu_torch.dag.channels import LocalChannel
from ray_tpu_torch.serve import batching, multiplex
from ray_tpu_torch.serve._common import DeadlineExceededError, RequestShedError
from ray_tpu_torch.serve.llm import observability as seq_obs
from ray_tpu_torch.serve.llm.batch import SequenceState, SlotBatch
from ray_tpu_torch.serve.llm.config import LLMConfig
from ray_tpu_torch.serve.llm.kv import KVBlockPool
from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)


class DecodeEngine:
    """Slot-based continuous batching over local channels. Single-owner:
    all state is touched only from the hosting replica's event loop.
    ``device`` holds the KV pool (a card, or "cpu" for host memory)."""

    # Idle admission wait when the batch is empty (engine parked).
    IDLE_POLL_S = 0.1

    def __init__(self, config: LLMConfig, model, *, deployment: str = "",
                 replica_id: str = "", device="cuda"):
        self.cfg = config
        self.model = model
        self.deployment = deployment
        self.replica_id = replica_id
        self._batch = SlotBatch(config.max_slots, config.slot_buckets)
        self._kv = KVBlockPool(config.num_kv_blocks, config.block_tokens, config.kv_dim,
                               device=device, deployment=deployment, replica_id=replica_id)
        self._admit_chan = LocalChannel(maxsize=max(1, config.max_queued_seqs),
                                        label=f"admit-{replica_id}")
        # Sequences whose KV could not be paged in yet (pool pressure).
        self._deferred: list[SequenceState] = []
        # Engine fence: every emitted token carries (fence, index). A client
        # resuming a stream after a replica's death sees a new fence from
        # the retry replica and dedups by index.
        self.fence = uuid.uuid4().hex[:8]
        self._task: asyncio.Task | None = None
        self._stopped = False
        # Stats.
        self.iterations = 0
        self.admitted = 0
        self.completed = 0
        self.shed = 0
        self.expired = 0
        self._last_bucket = 0
        self._occupancy_ewma = 0.0
        self._iter_rate = 0.0  # iterations/s EWMA
        self._last_iter_t = 0.0
        # Token goodput ledger: always on, integer arithmetic per token.
        self.ledger = seq_obs.TokenLedger()
        self._last_kv_note_t = 0.0

    # -- lifecycle ------------------------------------------------------
    def ensure_started(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()

    # -- admission ------------------------------------------------------
    def retry_after_estimate(self) -> float:
        """Seconds until a slot plausibly frees: the closest-to-done active
        sequence's remaining tokens at the observed iteration rate. Seeds
        the shed response's Retry-After (capped by the request's remaining
        budget at the proxy)."""
        active = self._batch.active()
        if not active or self._iter_rate <= 0:
            return 0.05
        remaining = min(s.max_tokens - len(s.generated) for _, s in active)
        return max(0.01, remaining / self._iter_rate)

    async def submit(self, seq: SequenceState) -> SequenceState:
        """Admits a sequence, shedding fast when the running batch AND the
        admission queue are full."""
        self.ensure_started()
        backlog = self._admit_chan.qsize() + len(self._deferred)
        if self._batch.free_count() == 0 and backlog >= self.cfg.max_queued_seqs:
            self.shed += 1
            self.ledger.seqs_shed += 1
            self._seq_record(seq, outcome="shed", cause="admission_shed", split={})
            est = self.retry_after_estimate()
            raise RequestShedError(
                f"decode batch full ({self._batch.occupancy()} slots, {backlog} queued); "
                f"retry_after_s={est:.3f}", retry_after_s=est)
        if seq.out_chan is None:
            seq.future = asyncio.get_running_loop().create_future()
        seq.admitted_at = time.monotonic()
        if not seq.enqueued_at:
            seq.enqueued_at = seq.admitted_at
        await self._admit_chan.put(seq)
        return seq

    # -- the resident loop ----------------------------------------------
    async def _loop(self) -> None:
        logger.info("decode engine %s: resident loop up (slots=%d buckets=%s kv_blocks=%d "
                    "device=%s fence=%s)", self.replica_id, self.cfg.max_slots,
                    list(self._batch.buckets), self.cfg.num_kv_blocks, self._kv.device,
                    self.fence)
        try:
            while not self._stopped:
                await self._iterate()
        except asyncio.CancelledError:
            pass
        except Exception as exc:
            # A crash must not strand submitters on futures that never
            # resolve: fail every sequence in flight, and let the next
            # submit() restart the loop.
            logger.exception("decode engine %s: loop crashed", self.replica_id)
            for idx, seq in self._batch.active():
                self._batch.evict(idx)
                self._release(seq)
                self._finish_ledger(seq, "shed", "engine_crash")
                await self._finish_error(seq, exc)
            for seq in self._deferred:
                self._finish_ledger(seq, "shed", "engine_crash")
                await self._finish_error(seq, exc)
            self._deferred = []

    async def _iterate(self) -> None:
        # 1. page in deferred sequences first (eviction may have freed the
        # pool since the last iteration).
        if self._deferred:
            still: list[SequenceState] = []
            for seq in self._deferred:
                if not self._try_page_in(seq):
                    still.append(seq)
            self._deferred = still
        # 2. admit arrivals into free slots: wait at most admit_poll_s while
        # the batch is live, park on the channel while it is idle.
        free = self._batch.free_count()
        if free > 0:
            busy = self._batch.occupancy() > 0 or self._deferred
            arrivals = await self._admit_chan.pop_batch(
                free, self.cfg.admit_poll_s if busy else self.IDLE_POLL_S)
            for seq in arrivals:
                if not self._try_page_in(seq):
                    self._deferred.append(seq)
        # 3. deadline eviction, queued or running.
        for idx, seq in self._batch.active():
            if seq.deadline.expired():
                self._batch.evict(idx)
                self._release(seq)
                self.expired += 1
                self._finish_ledger(seq, "evicted", "deadline")
                await self._finish_error(
                    seq, DeadlineExceededError("sequence deadline expired mid-decode"))
        self._deferred = [s for s in self._deferred
                          if not (s.deadline.expired() and self._expire_deferred(s))]
        active = self._batch.active()
        if not active:
            return
        # An armed mid-decode kill takes the replica down between iterations.
        try:
            chaos.failpoint("serve.llm.decode_iter")
        except chaos.ChaosFault:
            os._exit(1)
        # 4. one decode step over the active slots at the covering padded
        # bucket, KV pages gathered from the paged pool.
        bucket = self._batch.bucket_for(len(active))
        if bucket != self._last_bucket:
            batching.note_warm_shape(f"llm:{bucket}")
            self._last_bucket = bucket
        seqs = [s for _, s in active]
        kv_pages = [self._kv.read(s.kv_blocks) for s in seqs]
        # Parented on the first sampled active sequence's trace, so the
        # iteration that made a token sits in that sequence's trace tree.
        iter_span = None
        if tracing.enabled():
            parent = next((s.trace_ctx for s in seqs if s.sampled and s.trace_ctx), None)
            if parent is not None:
                iter_span = tracing.begin("decode.iter", parent=parent, replica=self.replica_id,
                                          slots=len(active), bucket=bucket)
        tokens = self.model.decode_step(seqs, kv_pages, bucket)
        # 5. append or stream tokens; evict completed sequences.
        self.ledger.issue(len(active))
        now_t = time.monotonic()
        for (idx, seq), tok in zip(active, tokens):
            seq.generated.append(int(tok))
            prev_t = seq.token_times[-1] if seq.token_times else 0.0
            seq.token_times.append(now_t)
            if len(seq.generated) == 1:
                seq.first_token_at = now_t
                metrics_mod.record_serve_token_latency(
                    "ttft", now_t - seq.enqueued_at, self.deployment)
            elif prev_t:
                metrics_mod.record_serve_token_latency("tpot", now_t - prev_t, self.deployment)
            if seq.out_chan is not None:
                event = {"i": len(seq.generated) - 1, "t": int(tok), "fence": self.fence}
                if seq.sampled and seq.trace_ctx:
                    # The trace id follows every token to the client.
                    event["tr"] = seq.trace_ctx["trace_id"]
                await seq.out_chan.put(event, trace=seq.trace_ctx if seq.sampled else None)
            if seq.done():
                self._batch.evict(idx)
                self._release(seq)
                self.completed += 1
                self._finish_ledger(seq, "productive", "completed")
                await self._finish_ok(seq)
        if iter_span is not None:
            tracing.finish(iter_span)
        # 6. per-iteration bookkeeping.
        self.iterations += 1
        now = time.monotonic()
        if self._last_iter_t:
            dt = max(1e-6, now - self._last_iter_t)
            self._iter_rate = 0.9 * self._iter_rate + 0.1 / dt
        self._last_iter_t = now
        occ = len(active)
        self._occupancy_ewma = 0.9 * self._occupancy_ewma + 0.1 * occ
        self._export_gauges(occ)
        self._note_kv_headroom(now)
        await asyncio.sleep(0)

    # -- sequence completion --------------------------------------------
    def _try_page_in(self, seq: SequenceState) -> bool:
        if self._batch.free_count() == 0:
            return False
        n = self._kv.blocks_needed(len(seq.prompt_tokens))
        ids = self._kv.alloc(n)
        if ids is None:
            return False
        if seq.kv_data is not None:
            self._kv.write(ids, seq.kv_data)
            seq.kv_data = None
        seq.kv_blocks = ids
        seq.slot_admitted_at = time.monotonic()
        self._batch.admit(seq)
        self.admitted += 1
        if seq.model_id:
            multiplex.pin_model(seq.model_id)
        return True

    def _release(self, seq: SequenceState) -> None:
        if seq.kv_blocks:
            self._kv.release(seq.kv_blocks)
            seq.kv_blocks = []
        if seq.model_id:
            multiplex.unpin_model(seq.model_id)

    def _expire_deferred(self, seq: SequenceState) -> bool:
        self.expired += 1
        self._finish_ledger(seq, "evicted", "kv_wait_deadline")
        task = asyncio.get_running_loop().create_task(self._finish_error(
            seq, DeadlineExceededError("sequence deadline expired before a KV page freed")))
        # Hold the task until it runs (the loop keeps tasks weakly).
        _PENDING.add(task)
        task.add_done_callback(_PENDING.discard)
        return True

    async def _finish_ok(self, seq: SequenceState) -> None:
        if seq.out_chan is not None:
            await seq.out_chan.put({"done": True, "n": len(seq.generated), "fence": self.fence})
        elif seq.future is not None and not seq.future.done():
            seq.future.set_result({"request_id": seq.request_id,
                                   "tokens": list(seq.generated), "fence": self.fence})

    async def _finish_error(self, seq: SequenceState, exc: Exception) -> None:
        if seq.out_chan is not None:
            await seq.out_chan.put({"error": f"{type(exc).__name__}: {exc}",
                                    "fence": self.fence})
        elif seq.future is not None and not seq.future.done():
            seq.future.set_exception(exc)

    # -- observability --------------------------------------------------
    def _finish_ledger(self, seq: SequenceState, outcome: str, cause: str) -> None:
        """Terminal accounting for one sequence: its tokens partitioned in
        the ledger and counted by class, and (sampled sequences) its
        timeline record."""
        split = self.ledger.classify(seq, outcome)
        metrics_mod.inc_serve_tokens(outcome, split["tokens"], self.deployment)
        metrics_mod.inc_serve_tokens("replay_discarded", split["replay_discarded"],
                                     self.deployment)
        self._seq_record(seq, outcome=outcome, cause=cause, split=split)

    def _export_gauges(self, occupancy: int) -> None:
        """This iteration's slot occupancy, tokens issued and KV blocks."""
        metrics_mod.set_serve_replica_gauge("slot_occupancy", self.deployment, self.replica_id,
                                            occupancy)
        metrics_mod.inc_serve_tokens("issued", occupancy, self.deployment)
        self._kv.export_gauges()

    def _seq_record(self, seq: SequenceState, *, outcome: str, cause: str,
                    split: dict) -> None:
        if not seq.sampled:
            return
        seq_obs.record(seq_obs.seq_record(
            seq, outcome=outcome, cause=cause, split=split, deployment=self.deployment,
            replica_id=self.replica_id, fence=self.fence))

    def _note_kv_headroom(self, now: float) -> None:
        """The KV pool's headroom on the sequence timeline, every 0.5 s."""
        if now - self._last_kv_note_t < 0.5:
            return
        self._last_kv_note_t = now
        seq_obs.record({
            "kind": "kv", "ts": time.time(), "deployment": self.deployment,
            "replica": self.replica_id, "kv_free_frac": round(self._kv.free_frac(), 4),
            "kv_blocks_used": self._kv.used(), "kv_blocks_free": self._kv.free(),
        })

    def queue_depth(self) -> int:
        return self._admit_chan.qsize() + len(self._deferred)

    def stats(self) -> dict:
        """Per-iteration view for the replica's get_metrics(): the slot
        occupancy stands for the batch-boundary occupancy."""
        occ = self._batch.occupancy()
        bucket = self._batch.bucket_for(occ) if occ else 0
        return {
            "slot_occupancy": occ,
            "slot_occupancy_frac": (occ / bucket) if bucket else 0.0,
            "avg_slot_occupancy": round(self._occupancy_ewma, 3),
            "decode_bucket": bucket,
            "iterations": self.iterations,
            "iter_rate_s": round(self._iter_rate, 3),
            "admitted": self.admitted,
            "completed": self.completed,
            "shed": self.shed,
            "expired": self.expired,
            "queue_depth": self.queue_depth(),
            "kv_blocks_used": self._kv.used(),
            "kv_blocks_free": self._kv.free(),
            "kv_free_frac": round(self._kv.free_frac(), 4),
            "fence": self.fence,
            "token_ledger": self.ledger.snapshot(),
        }

    def load(self) -> dict:
        """The autoscaler's inputs: ongoing slots and queued sequences, and
        the KV pool's free fraction (its headroom)."""
        return {"ongoing": self._batch.occupancy(), "queue_depth": self.queue_depth(),
                "kv_free_frac": self._kv.free_frac()}


# Completion tasks of expired deferred sequences, held until they run.
_PENDING: set = set()
