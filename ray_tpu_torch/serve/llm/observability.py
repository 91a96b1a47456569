"""Token-level serve-LLM observability.

The port's copy of ray_tpu's ``serve/llm/observability.py``. Three pieces,
all owned by the decode replica's event loop:

* **TokenLedger**: every token the decode step issues is eventually
  classified into exactly one of ``productive`` / ``shed`` / ``evicted`` /
  ``replay_discarded`` when its sequence ends, so ``issued == classified
  + in_flight`` holds at every instant. A replayed sequence
  (``resume_from`` > 0) charges its first ``resume_from`` tokens to
  ``replay_discarded``.

* **Per-sequence timelines**: one JSONL record per finished sampled
  sequence (``sequences-<pid>.jsonl``), and periodic ``kv`` records of the
  KV pool's headroom, in the span exporter's directory
  (``util.tracing._export_dir()``: ``<session_dir>/tracing/``), so that
  ``util.timeline.build_sequence_trace`` reads spans and records from one
  place. Without a session directory they are dropped.

* **Sampling**: ``LLMConfig.seq_trace_sample`` gates the traced path by a
  deterministic hash of request_id, while tracing is on: a sampled
  sequence carries its request's trace context, parents the
  ``serve.kv_transfer`` and ``decode.iter`` spans, and stamps its trace id
  on each token event and on its timeline record.
"""

from __future__ import annotations

import atexit
import glob
import hashlib
import json
import os
import threading
import time

# Terminal ledger classes, in the order summaries render them.
TOKEN_CLASSES = ("productive", "shed", "evicted", "replay_discarded")


def sampled(request_id: str, sample: float) -> bool:
    """Deterministic per-sequence sampling decision: a blake2b hash of the
    request id against the configured fraction."""
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    h = hashlib.blake2b(request_id.encode(), digest_size=4).digest()
    return int.from_bytes(h, "big") / 0xFFFFFFFF < sample


class TokenLedger:
    """Exact-sum token accounting: ``issued`` counts every token the decode
    step emits; terminal classification partitions them."""

    __slots__ = ("issued", "productive", "shed", "evicted", "replay_discarded", "seqs_shed")

    def __init__(self):
        self.issued = 0
        self.productive = 0
        self.shed = 0
        self.evicted = 0
        self.replay_discarded = 0
        # Sequences shed at admission never issue a token; counted apart.
        self.seqs_shed = 0

    def issue(self, n: int = 1) -> None:
        self.issued += n

    def classify(self, seq, outcome: str) -> dict:
        """Charges a finished sequence's tokens: the first ``resume_from``
        to ``replay_discarded``, the rest to ``outcome``. Returns the split."""
        n = len(seq.generated)
        replayed = min(max(int(getattr(seq, "resume_from", 0)), 0), n)
        fresh = n - replayed
        self.replay_discarded += replayed
        setattr(self, outcome, getattr(self, outcome) + fresh)
        return {"class": outcome, "tokens": fresh, "replay_discarded": replayed}

    def in_flight(self) -> int:
        return self.issued - (self.productive + self.shed + self.evicted
                              + self.replay_discarded)

    def snapshot(self) -> dict:
        return {
            "issued": self.issued,
            "productive": self.productive,
            "shed": self.shed,
            "evicted": self.evicted,
            "replay_discarded": self.replay_discarded,
            "in_flight": self.in_flight(),
            "seqs_shed": self.seqs_shed,
        }


# -- sequence timeline exporter ---------------------------------------------
# A thread-safe list of records and one batched write per flush.

_lock = threading.Lock()
_buffer: list[dict] = []
_flusher_started = False
# Age-based drain: a decode replica writes one record per sequence, so a
# full batch may take minutes to gather.
_FLUSH_AGE_S = 0.5


def _export_path() -> str | None:
    from ray_tpu_torch.util import tracing

    base = tracing._export_dir()
    if base is None:
        return None
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, f"sequences-{os.getpid()}.jsonl")


def _flush_loop() -> None:
    while True:
        time.sleep(_FLUSH_AGE_S)
        try:
            flush()
        except OSError:
            pass  # keep the daemon alive through a failed write; the next tick retries


def _ensure_flusher() -> None:
    global _flusher_started
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True
    threading.Thread(target=_flush_loop, name="raytpu-seq-flusher", daemon=True).start()
    atexit.register(flush)


def record(rec: dict) -> None:
    """Buffers one timeline record (``kind`` "seq" or "kv")."""
    with _lock:
        _buffer.append(rec)
        should_flush = len(_buffer) >= 256
    if not _flusher_started:
        _ensure_flusher()
    if should_flush:
        flush()


def flush() -> None:
    with _lock:
        batch, _buffer[:] = _buffer[:], ()
    if not batch:
        return
    path = _export_path()
    if path is None:
        return
    lines = "".join(json.dumps(rec, separators=(",", ":")) + "\n" for rec in batch)
    with open(path, "a") as fh:
        fh.write(lines)


def read_sequences(session_dir: str) -> list[dict]:
    """Every sequence and kv timeline record exported under a session."""
    flush()
    out: list[dict] = []
    for path in sorted(glob.glob(os.path.join(session_dir, "tracing", "sequences-*.jsonl"))):
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        except OSError:
            continue
    return out


def percentile(values, frac: float) -> float:
    """Nearest-rank percentile over a small list."""
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(frac * len(ordered)))
    return float(ordered[idx])


def seq_record(seq, *, outcome: str, cause: str, split: dict, deployment: str,
               replica_id: str, fence: str) -> dict:
    """The terminal timeline record of one sequence: relative spans in
    seconds (monotonic differences) and one wall-clock ``ts``."""
    gaps = [b - a for a, b in zip(seq.token_times, seq.token_times[1:])]
    ttft = (seq.first_token_at - seq.enqueued_at
            if seq.first_token_at and seq.enqueued_at else 0.0)
    queue_wait = (seq.slot_admitted_at - seq.enqueued_at
                  if seq.slot_admitted_at and seq.enqueued_at else 0.0)
    return {
        "kind": "seq",
        "ts": time.time(),
        "request_id": seq.request_id,
        "trace_id": (seq.trace_ctx or {}).get("trace_id", ""),
        "deployment": deployment,
        "replica": replica_id,
        "fence": fence,
        "outcome": outcome,
        "cause": cause,
        "tokens": len(seq.generated),
        "replay_discarded": split.get("replay_discarded", 0),
        "queue_wait_s": round(queue_wait, 6),
        "prefill_s": round(seq.prefill_s, 6),
        "kv_transfer_s": round(seq.kv_transfer_s, 6),
        "ttft_s": round(ttft, 6),
        "tpot_p50_s": round(percentile(gaps, 0.50), 6),
        "tpot_p99_s": round(percentile(gaps, 0.99), 6),
        # Relative token emission times (against enqueue), capped.
        "token_rel_s": [round(t - seq.enqueued_at, 6) for t in seq.token_times[:512]]
        if seq.enqueued_at else [],
    }
