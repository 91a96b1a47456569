"""Prefill/decode deployments and the app builder.

The port's copy of ray_tpu's ``serve/llm/deployments.py``. Disaggregation:
``LLMPrefill`` replicas run the prompt pass and emit KV blocks on the
quantized wire; ``LLMDecode`` replicas own a paged KV pool and the
resident continuous-batching engine. They are separate deployments, so
the controller scales the pools independently: prefill on its queue,
decode on its slots and on its KV headroom (``kv_headroom_min``).

A generate request enters through the decode pool, which calls the
prefill pool through a DeploymentHandle: the KV payload rides the reply
(the inline wire). ``wire.KVDeviceWire`` moves the same payload between
processes over a collective group's p2p when one is available.

The default model is a deterministic toy LM: token *i* of a sequence is a
digest of (model id, prompt, i), so retried or replayed decodes give the
same tokens byte for byte. ``ToyLM`` stays host numpy: its tokens are
blake2b digests and its KV a float64 ``np.sin`` cast to f32, both defined
bit for bit by the reference (``torch.sin`` on a card need not round the
same way). Its synthetic decode compute (``decode_flops``) runs as a
``torch.matmul`` on the pool's device in a decode replica; it changes no
output.

The device follows the replica's placement: a decode replica the
controller placed on a card (``CUDA_VISIBLE_DEVICES`` naming it) holds its
pool there, and raises if CUDA is not there; one with no GPU share
(``CUDA_VISIBLE_DEVICES`` empty) holds it in host memory. The prefill
replicas run on the host.

``steady_rpc_probe`` counts the calls this replica process sends to the
serve controller over the serve wire (``_channel.calls_sent``), less the
one background uplink the port has: the membership subscriber's parked
``poll_update`` (``long_poll.PARKED_POLL``). The reference subtracts its
metrics flush and task-event report, which the port has neither of.

With tracing on, a prompt pass is a ``serve.prefill`` span under the
request's ``serve.replica`` span, and a sampled sequence
(``seq_trace_sample``) takes the request's context and a backdated
``serve.kv_transfer`` span for its KV decode into the pool. The prefill
replica sleeps first for the chaos latency point ``serve.llm.prefill``.
Left out until the port has metrics (ROADMAP Queue A item 14b-ii): the
TTFT and TPOT histograms and the replica's gauges.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import time
import uuid
from typing import Any, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private import chaos
from ray_tpu_torch.serve import _channel, long_poll
from ray_tpu_torch.serve._common import Deadline, current_deadline
from ray_tpu_torch.serve.llm import observability as seq_obs
from ray_tpu_torch.serve.llm.batch import SequenceState
from ray_tpu_torch.serve.llm.config import LLMConfig
from ray_tpu_torch.serve.llm.engine import DecodeEngine
from ray_tpu_torch.serve.llm.wire import decode_kv_blocks, encode_kv_blocks
from ray_tpu_torch.serve.multiplex import multiplexed
from ray_tpu_torch.util import tracing


def _digest(*parts) -> int:
    h = hashlib.blake2b("|".join(str(p) for p in parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def tokenize(prompt) -> List[int]:
    """Prompts are strings (whitespace-hashed) or token-id lists."""
    if isinstance(prompt, str):
        return [_digest("tok", w) % 50000 for w in prompt.split() or [""]]
    return [int(t) for t in prompt]


def replica_device() -> torch.device:
    """Where this process's decode replica holds its KV pool: host memory
    when ``CUDA_VISIBLE_DEVICES`` is set and empty (a replica with no GPU
    share), else the card, which must be there."""
    if os.environ.get("CUDA_VISIBLE_DEVICES", None) == "":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"this decode replica holds a GPU share (CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}) and CUDA is not available; a replica "
            f"without a card sets num_gpus=0")
    return torch.device("cuda")


class ToyLM:
    """Deterministic stand-in model: prefill emits smooth KV in [-1, 1]
    (friendly to the block-scaled int8 wire), decode emits digest tokens
    that every replica and restart reproduces. ``device``: where the
    synthetic decode compute runs."""

    def __init__(self, config: LLMConfig, device="cpu"):
        self.cfg = config
        self.device = torch.device(device)

    def prefill(self, tokens: List[int], model_id: str = "") -> np.ndarray:
        t = np.asarray(tokens, dtype=np.float64)
        pos = np.arange(1, self.cfg.kv_dim + 1, dtype=np.float64)
        seed = (_digest("m", model_id) % 997) / 997.0
        kv = np.sin(np.outer(t * 1e-3 + seed, pos * 0.1))
        if self.cfg.prefill_flops > 0:
            # Synthetic compute knob: a prompt pass.
            n = max(2, int(self.cfg.prefill_flops ** 0.5))
            a = np.ones((n, n), dtype=np.float32)
            a @ a
        return kv.astype(np.float32)

    def decode_step(self, seqs, kv_pages, bucket: int) -> List[int]:
        """One token for every active slot. The synthetic compute runs at
        the padded bucket shape; the padding rows are dead weight."""
        if self.cfg.decode_flops > 0:
            n = max(2, int(self.cfg.decode_flops ** 0.5))
            torch.matmul(torch.ones((bucket, n), device=self.device),
                         torch.ones((n, n), device=self.device))
        del kv_pages  # toy decode: KV fidelity is tracked wire-side
        return [_digest(s.model_id, tuple(s.prompt_tokens), len(s.generated))
                % self.cfg.vocab_size for s in seqs]


class _ModelAdapter:
    """A multiplexed 'model' (a LoRA stand-in): the weights are the id; the
    object exercises the load, checkpoint and unload lifecycle and the
    pin that defers an eviction while a sequence runs it."""

    def __init__(self, model_id: str):
        self.model_id = model_id
        self.loaded_at = time.monotonic()
        self.checkpointed = 0

    def checkpoint(self) -> None:
        self.checkpointed += 1

    def unload(self) -> None:
        pass


class LLMPrefill:
    """Prefill pool replica: tokenize, prompt pass, encode KV for the wire.
    Stateless per request."""

    def __init__(self, config: Any = None):
        self.cfg = LLMConfig.from_any(config)
        self._wire_cfg = self.cfg.wire_config()
        self._model = ToyLM(self.cfg)
        self._served = 0

    async def prefill(self, body: dict) -> dict:
        extra = chaos.latency_delay("serve.llm.prefill")
        if extra > 0:
            await asyncio.sleep(extra)
        prompts = body.get("prompts") or [body.get("prompt", "")]
        model_id = str(body.get("model", "") or "")
        seqs = []
        for prompt in prompts:
            tokens = tokenize(prompt)
            kv = self._model.prefill(tokens, model_id)
            seqs.append({
                "tokens": tokens,
                "kv": encode_kv_blocks(kv, self._wire_cfg),
                # Wire fidelity: decode compares the payload's roundtrip
                # against this to track the quantization error.
                "sig": float(np.mean(np.abs(kv))),
            })
        self._served += len(seqs)
        return {"seqs": seqs, "quantized": bool(self._wire_cfg), "served": self._served}

    async def __call__(self, body: dict) -> dict:
        return await self.prefill(body if isinstance(body, dict) else {})


class LLMDecode:
    """Decode pool replica: hosts the resident continuous-batching engine
    and the paged KV pool on the replica's device; calls the prefill pool
    for prompt passes (the KV payload rides the reply)."""

    def __init__(self, config: Any = None, prefill: Any = None):
        self.cfg = LLMConfig.from_any(config)
        self._device = replica_device()
        self._engine = DecodeEngine(self.cfg, ToyLM(self.cfg, device=self._device),
                                    deployment="llm_decode", device=self._device)
        self._prefill = prefill  # DeploymentHandle or None (one pool)
        self._local_prefill = LLMPrefill(self.cfg)
        # An EWMA on the pool's device, read only by serve_llm_stats.
        self._kv_wire_err = torch.zeros((), device=self._device)

    # -- multiplexing ---------------------------------------------------
    # Bound at class definition; the per-replica cap is the decorator's.
    @multiplexed(max_num_models_per_replica=3)
    async def _load_model(self, model_id: str) -> _ModelAdapter:
        return _ModelAdapter(model_id)

    # -- prefill hop ----------------------------------------------------
    def _run_prefill(self, payload: dict) -> dict:
        handle = self._prefill.options(method_name="prefill")
        return handle.remote(payload).result()

    async def _prefill_seqs(self, prompts: list, model_id: str) -> list:
        payload = {"prompts": prompts, "model": model_id}
        # The prompt pass is a phase of the request's trace (the ambient
        # serve.replica span parents it); a no-op while tracing is off.
        with tracing.span("serve.prefill", prompts=len(prompts), inline=self._prefill is None):
            if self._prefill is None:
                out = await self._local_prefill.prefill(payload)
            else:
                # One call per admission batch; to_thread keeps the blocking
                # handle call off the engine's loop and carries the ambient
                # deadline and span with it.
                out = await asyncio.to_thread(self._run_prefill, payload)
        return out["seqs"]

    def _make_seq(self, entry: dict, body: dict, model_id: str, deadline: Deadline, *,
                  enqueued_at: float = 0.0, prefill_s: float = 0.0) -> SequenceState:
        t0 = time.monotonic()
        kv = decode_kv_blocks(entry["kv"], self._device)
        kv_transfer_s = time.monotonic() - t0
        err = (kv.abs().mean() - entry.get("sig", 0.0)).abs()
        self._kv_wire_err = 0.9 * self._kv_wire_err + 0.1 * err
        request_id = str(body.get("request_id", "") or uuid.uuid4().hex[:12])
        seq = SequenceState(
            request_id=request_id,
            prompt_tokens=entry["tokens"],
            max_tokens=int(body.get("max_tokens", self.cfg.max_tokens_default)),
            session_id=str(body.get("session_id", "") or ""),
            model_id=model_id,
            kv_data=kv,
            deadline=deadline,
        )
        seq.enqueued_at = enqueued_at
        seq.prefill_s = prefill_s
        seq.kv_transfer_s = kv_transfer_s
        # After a replica's death, how many tokens the client already
        # holds under the old fence: the ledger charges them as replays.
        seq.resume_from = int(body.get("resume_from", 0) or 0)
        # A deterministic decision keeps a replayed request's tracing fate
        # (and its trace id, in the retried request's context) stable.
        seq.sampled = tracing.enabled() and seq_obs.sampled(request_id,
                                                            self.cfg.seq_trace_sample)
        if seq.sampled:
            seq.trace_ctx = tracing.inject()
            if seq.trace_ctx and kv_transfer_s > 0:
                # Backdated: the sampling decision needs request_id, known
                # only after the decode ran.
                end_ns = time.time_ns()
                tracing.emit("serve.kv_transfer", seq.trace_ctx,
                             start_ns=end_ns - int(kv_transfer_s * 1e9), end_ns=end_ns,
                             request_id=request_id,
                             quantized=entry["kv"][0] != "__kv_exact")
        return seq

    # -- request surface ------------------------------------------------
    async def generate(self, body: Any = None):
        """One sequence. ``stream=True`` returns an async generator of
        ``{"i", "t", "fence"}`` token events (the replica streams it);
        otherwise waits for the sequence's end."""
        body = body if isinstance(body, dict) else {"prompt": body or ""}
        t0 = time.monotonic()
        deadline = current_deadline() or Deadline.never()
        model_id = str(body.get("model", "") or "")
        if model_id:
            await self._load_model(model_id)
        entries = await self._prefill_seqs([body.get("prompt", "")], model_id)
        prefill_s = time.monotonic() - t0
        seq = self._make_seq(entries[0], body, model_id, deadline, enqueued_at=t0,
                             prefill_s=prefill_s)
        if body.get("stream"):
            from ray_tpu_torch.dag.channels import LocalChannel

            seq.out_chan = LocalChannel(maxsize=seq.max_tokens + 8,
                                        label=f"out-{seq.request_id}")
            await self._engine.submit(seq)

            async def _token_events():
                while True:
                    events = await seq.out_chan.pop_batch(
                        64, max(0.05, deadline.remaining(cap=30.0)))
                    if not events and deadline.expired():
                        raise TimeoutError("stream deadline expired")
                    for event in events:
                        if event.get("done"):
                            return
                        if "error" in event:
                            raise RuntimeError(event["error"])
                        yield event

            return _token_events()
        await self._engine.submit(seq)
        return await seq.future

    async def generate_batch(self, body: dict) -> dict:
        """Admission-batched unary path (the bench's driver): one prefill
        call and one admission wave for N sequences, each completed as its
        slot finishes."""
        body = body if isinstance(body, dict) else {}
        t0 = time.monotonic()
        deadline = current_deadline() or Deadline.never()
        model_id = str(body.get("model", "") or "")
        if model_id:
            await self._load_model(model_id)
        prompts = list(body.get("prompts", ()))
        entries = await self._prefill_seqs(prompts, model_id)
        prefill_s = time.monotonic() - t0
        seqs = [self._make_seq(e, body, model_id, deadline, enqueued_at=t0,
                               prefill_s=prefill_s) for e in entries]
        for seq in seqs:
            await self._engine.submit(seq)
        results = await asyncio.gather(*(s.future for s in seqs))
        return {"results": list(results), "fence": self._engine.fence}

    async def __call__(self, body: Any = None):
        return await self.generate(body)

    # -- control and observability --------------------------------------
    def serve_llm_stats(self) -> dict:
        """The engine's stats, the wire's error, and where the pool lives
        (its device and its arena's bytes there)."""
        stats = self._engine.stats()
        stats["kv_wire_err"] = round(float(self._kv_wire_err), 6)
        arena = self._engine._kv._arena
        stats["kv_device"] = str(arena.device)
        stats["kv_pool_bytes"] = arena.untyped_storage().nbytes()
        return stats

    def serve_llm_load(self) -> dict:
        return self._engine.load()

    async def steady_rpc_probe(self, iters: int = 100, timeout_s: float = 30.0,
                               windows: int = 3) -> dict:
        """Runs up to ``windows`` windows of ``iters`` decode iterations
        under whatever traffic flows and counts the calls this process
        sends to the serve controller in each: continuous batching must
        report 0. The parked long poll (``long_poll.PARKED_POLL``) is a
        background uplink, not decode-loop work, and is subtracted by name;
        anything else is a finding, and the per-name split says where it
        came from. The best of the windows that reached ``iters`` is
        reported (``controller_rpcs`` None when none did); a window cut
        short by ``timeout_s`` is listed in ``window_iterations`` and judged
        by none. A window with no call ends the probe, since no later one
        can report fewer."""
        if isinstance(iters, dict):  # an HTTP-style dict body, as generate()'s
            body, iters = iters, 100
            iters = int(body.get("iters", iters))
            timeout_s = float(body.get("timeout_s", timeout_s))
            windows = int(body.get("windows", windows))
        uplinks = (long_poll.PARKED_POLL,)
        address = long_poll.controller_address()

        def sent() -> dict:
            return _channel.calls_sent(address) if address is not None else {}

        best: int | None = None
        best_names: dict[str, int] = {}
        best_iters = 0
        window_iters: list[int] = []
        deadline = time.monotonic() + timeout_s
        for _ in range(max(1, windows)):
            if time.monotonic() >= deadline:
                break
            start_iter = self._engine.iterations
            before = sent()
            while (self._engine.iterations < start_iter + iters
                   and time.monotonic() < deadline):
                await asyncio.sleep(0.005)
            done = self._engine.iterations - start_iter
            window_iters.append(done)
            if done < iters:
                continue
            deltas = {name: n - before.get(name, 0) for name, n in sent().items()
                      if n - before.get(name, 0) > 0 and name not in uplinks}
            if best is None or sum(deltas.values()) < best:
                best, best_names, best_iters = sum(deltas.values()), deltas, done
            if best == 0:
                break
        return {"iterations": sum(window_iters), "window_iterations": window_iters,
                "best_window_iterations": best_iters, "controller_rpcs": best,
                "rpc_methods": best_names}


def build_llm_app(
    config: Any = None,
    *,
    prefill_replicas: int = 1,
    decode_replicas: int = 1,
    prefill_autoscaling: Optional[dict] = None,
    decode_autoscaling: Optional[dict] = None,
    max_ongoing_requests: int = 256,
    request_timeout_s: float = 60.0,
    prefill_options: Optional[dict] = None,
    decode_options: Optional[dict] = None,
):
    """Binds the disaggregated app: the decode pool (ingress) composed over
    the prefill pool. Autoscaling dicts let each pool resize on its own;
    decode's may set ``kv_headroom_min`` to scale on KV-pool pressure.
    ``prefill_options`` / ``decode_options`` are more ``serve.deployment``
    arguments a pool (``retry_policy``, ``health_check_period_s``,
    ``ray_actor_options={"num_gpus": ...}`` for decode pools on cards)."""
    from ray_tpu_torch import serve

    cfg = LLMConfig.from_any(config).to_dict()
    prefill_dep = serve.deployment(
        LLMPrefill, name="llm_prefill", num_replicas=prefill_replicas,
        max_ongoing_requests=max_ongoing_requests, autoscaling_config=prefill_autoscaling,
        request_timeout_s=request_timeout_s, **(prefill_options or {}))
    decode_dep = serve.deployment(
        LLMDecode, name="llm_decode", num_replicas=decode_replicas,
        max_ongoing_requests=max_ongoing_requests, autoscaling_config=decode_autoscaling,
        request_timeout_s=request_timeout_s, **(decode_options or {}))
    return decode_dep.bind(cfg, prefill_dep.bind(cfg))
