"""KV-block wire: prefill -> decode handoff payloads.

The port's copy of ray_tpu's ``serve/llm/wire.py``. Two transports share
one codec:

* **inline**: the KV payload rides the prefill call's reply (the decode
  replica calls the prefill pool through a DeploymentHandle and the
  encoded blocks come back in the result). What the release bench runs.
* **device**: ``KVDeviceWire`` moves the payload between processes over a
  collective group's tagged p2p (``send``/``recv(tag=, timeout=)``, as the
  port's ``RingGroup`` has them), tagged ``kvblk:p{epoch}:e{src}:{dst}:{seq}``.
  The epoch hole fences frames sent before a recovery out of a re-opened
  wire: a frame sent before an epoch bump lands in a mailbox no later pop
  reads.

Payloads are block-scale quantized with the collective codec
(``util/collective/quantization.py``) when the config carries a wire
quantize mode; ``kv_wire_quantize=None`` is the exact wire. For the same
f32 KV the encoded bytes are the reference's (fp8's as uint8 bits). Error
feedback stays off: a handoff is one-shot.

On the decode side a payload decodes on the pool's device
(``decode_kv_blocks(payload, device)``): a quantized one through the
codec's ``decode_device``, so the int8 or fp8 bytes and the scales cross to
the card, not the f32 KV, and cross without a wait (pinned host buffers,
copies queued on the stream). Without a device it decodes to numpy, as
the reference does; ``wire_error`` measures the wire that way.

Left out until the port has tracing (ROADMAP Queue A item 14a): the
trace-context envelope (``_TR_WIRE``) and the ``channel.push`` /
``channel.pop`` spans; ``last_trace`` stays None. The comm flight
recorder's ``serve_llm`` site marks stay.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.util.collective import flight

# Self-describing payload markers, so mixed exact and quantized wires share
# one decode path.
_KV_EXACT = "__kv_exact"
_KV_Q = "__kv_q"


def encode_kv_blocks(kv: np.ndarray, wire_cfg=None) -> tuple:
    """(marker, shape, payload): exact float32 bytes, or the block-scaled
    encoding when ``wire_cfg`` asks for quantization."""
    kv = np.ascontiguousarray(kv, dtype=np.float32)
    if wire_cfg is None or not getattr(wire_cfg, "quantize", None):
        return (_KV_EXACT, kv.shape, kv)
    from ray_tpu_torch.util.collective.quantization import encode

    return (_KV_Q, kv.shape, encode(kv.reshape(-1), wire_cfg))


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card through a pinned buffer, the
    copy queued on the current stream without a wait."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def decode_kv_blocks(payload: tuple, device=None):
    """The KV of a payload: a float32 numpy array, or with ``device`` a
    float32 tensor decoded there."""
    marker, shape, data = payload
    if marker not in (_KV_EXACT, _KV_Q):
        raise ValueError(f"unknown KV wire marker: {marker!r}")
    if device is None:
        if marker == _KV_EXACT:
            return np.asarray(data, dtype=np.float32).reshape(shape)
        from ray_tpu_torch.util.collective.quantization import decode

        return decode(data).reshape(shape).astype(np.float32)
    device = torch.device(device)
    if marker == _KV_EXACT:
        return _to_device(np.asarray(data, dtype=np.float32), device).reshape(shape)
    from ray_tpu_torch.util.collective.quantization import decode_device

    kind, q, scales, n = data
    encoded = (kind, _to_device(q, device), _to_device(scales, device), n)
    return decode_device(encoded, device).reshape(shape)


def wire_error(original: np.ndarray, payload: tuple) -> float:
    """Mean |roundtrip - original|: the KV wire's fidelity (a quantized
    wire stays near-exact; the exact wire is exactly zero)."""
    back = decode_kv_blocks(payload)
    return float(np.mean(np.abs(back - np.asarray(original, np.float32))))


class KVDeviceWire:
    """One prefill -> decode edge on a collective group's p2p.

    ``src``/``dst`` are the wire's rank endpoints inside the group,
    ``epoch`` is the channel epoch (bumped on a replica's recovery, see
    ``bump_epoch``), and ``seq`` is the per-wire handoff ordinal. The tag
    skeleton has all-integer holes. ``device``: where ``pop`` decodes (the
    decode replica's pool device).
    """

    def __init__(self, group, peer: int, *, device, src: int = 0, dst: int = 1,
                 epoch: int = 0, wire_cfg=None):
        self._group = group
        self._peer = peer
        self._src = src
        self._dst = dst
        self._wire_cfg = wire_cfg
        self._device = torch.device(device)
        self.epoch = epoch
        # The trace context of the last pop: None until the port has tracing.
        self.last_trace: dict | None = None

    def bump_epoch(self) -> None:
        """Fences the wire after a peer's recovery: frames tagged with the
        old epoch become unreadable, so a replayed handoff is delivered
        exactly once."""
        self.epoch += 1

    def _tag(self, seq: int) -> str:
        return f"kvblk:p{self.epoch}:e{self._src}:{self._dst}:{seq}"

    def push(self, seq: int, kv: np.ndarray) -> None:
        payload = encode_kv_blocks(kv, self._wire_cfg)
        with flight.site("serve_llm"):
            self._group.send(payload, self._peer, tag=self._tag(seq))

    def pop(self, seq: int, *, timeout: float = 60.0):
        with flight.site("serve_llm"):
            payload = self._group.recv(self._peer, tag=self._tag(seq), timeout=timeout)
        return decode_kv_blocks(payload, self._device)
