"""LLMConfig: every knob of the serve-LLM layer in one dataclass.

The port's copy of ray_tpu's ``serve/llm/config.py``, with the same fields
and defaults. One config object flows driver -> deployment init ->
prefill/decode replicas as a plain dict through serve's init args, so it
pickles without help. ``wire_config()`` returns the port's
``util/collective/quantization.CollectiveConfig``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional


@dataclass
class LLMConfig:
    """Knobs for the continuous-batching engine and the KV handoff.

    The defaults describe a toy deterministic LM sized so the whole
    serving path (admission, paged KV, bucketed decode, eviction) runs at
    full fidelity; a real model plugs in through ``deployments.LLMPrefill``
    / ``LLMDecode`` subclasses overriding the model hooks.
    """

    model_id: str = "toy"
    vocab_size: int = 32000

    # -- KV geometry ----------------------------------------------------
    # Floats of KV state per prompt token, paged into fixed-size blocks
    # (block_tokens tokens a block) in the decode replica's KVBlockPool.
    kv_dim: int = 16
    block_tokens: int = 16
    num_kv_blocks: int = 4096

    # -- continuous batching --------------------------------------------
    # max_slots bounds the running batch; slot_buckets are the padded batch
    # shapes the decode step runs at (the admitted count rounds up to the
    # smallest covering bucket).
    max_slots: int = 64
    slot_buckets: tuple = (8, 16, 32, 64)
    # Admission queue bound: sequences waiting for a free slot. Beyond it
    # the engine sheds fast (503 + Retry-After at the proxy).
    max_queued_seqs: int = 256
    max_tokens_default: int = 8
    # Idle wait (seconds) on the admission channel while the running batch
    # is non-empty: bounds admission latency without a hot loop.
    admit_poll_s: float = 0.002

    # -- KV wire (prefill -> decode) ------------------------------------
    # Block-scaled quantized wire through the collective codec; None is
    # the exact wire.
    kv_wire_quantize: Optional[str] = "int8"
    kv_wire_block: int = 64

    # -- synthetic compute ----------------------------------------------
    prefill_flops: int = 0
    decode_flops: int = 0

    # -- sequence observability -----------------------------------------
    # Fraction of sequences traced; the decision is a deterministic hash
    # of request_id. The port has no tracing yet (ROADMAP Queue A item
    # 14a), so no sequence is sampled whatever this says.
    seq_trace_sample: float = 1.0

    # -- multiplexing ---------------------------------------------------
    max_models_per_replica: int = 3

    def wire_config(self):
        """CollectiveConfig for the KV wire, or None for the exact wire.
        Error feedback stays off: a KV handoff is one-shot, so a residual
        would correct nothing."""
        if not self.kv_wire_quantize:
            return None
        from ray_tpu_torch.util.collective.quantization import CollectiveConfig

        return CollectiveConfig(
            quantize=self.kv_wire_quantize,
            block_size=self.kv_wire_block,
            error_feedback=False,
        )

    def to_dict(self) -> dict:
        d = asdict(self)
        d["slot_buckets"] = list(self.slot_buckets)
        return d

    @classmethod
    def from_any(cls, value) -> "LLMConfig":
        if isinstance(value, LLMConfig):
            return value
        if value is None:
            return cls()
        known = {k: v for k, v in dict(value).items() if k in cls.__dataclass_fields__}
        if "slot_buckets" in known:
            known["slot_buckets"] = tuple(known["slot_buckets"])
        return cls(**known)
