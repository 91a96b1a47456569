"""Block-scaled wire quantization for the host-memory collectives.

Port of ray_tpu's ``util/collective/quantization.py``: a flat f32 vector
is split into fixed-size blocks, each quantized against its own
absmax-derived scale, to int8 (a quarter of f32's wire bytes, plus one f32
scale a block) or to float8_e4m3fn. :class:`ErrorFeedback` keeps a
residual per call site and adds it to the next message from that site, so
a step's rounding error is paid back at the next step.

Wire format, as the reference's::

    ("q8"|"f8", q: np.ndarray, scales: np.ndarray(f32), n: int)

``q`` is the padded block matrix flattened (int8, or fp8's bits as uint8:
the port has no ml_dtypes) and ``n`` the element count before padding.

Two versions of the codec give the same bits:

* ``encode_plain`` / ``decode_plain``: the reference's numpy codec, the
  yardstick; its fp8 cast is torch's ``float8_e4m3fn`` on the CPU;
* ``encode`` / ``decode`` / ``ErrorFeedback`` on a ``torch.Tensor`` run as
  torch operations on the tensor's own device: a gradient on the card is
  encoded there, and only ``q`` and ``scales`` cross to the host
  (``encode_device`` keeps them on the device). A numpy array takes the
  plain version.

The bits match the reference's because every step is the same IEEE f32
operation: ``np.array_split``'s zero padding, absmax / 127 (or / 448)
divided tensor by tensor (a divide by a host scalar may become a
reciprocal multiply on the card), a zero block's scale taken as 1, the
divide, ``torch.round`` (half to even, as ``np.rint``), the clip, and on
decode the product of ``q`` and the scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_INT8_MAX = 127.0
_FP8_E4M3_MAX = 448.0

_KINDS = (None, "int8", "fp8")

_FP8 = getattr(torch, "float8_e4m3fn", None)


def fp8_supported() -> bool:
    return _FP8 is not None


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    """Opt-in knobs for the collective layer's wire path.

    quantize       -- None (exact wire), "int8" (block-scaled int8), or
                      "fp8" (block-scaled float8_e4m3fn; int8 where torch
                      has no float8 type).
    block_size     -- elements per scale block: 4 bytes of scale a block,
                      so int8 costs ``1 + 4/block_size`` bytes an element.
    error_feedback -- keep per-site residuals so quantization error
                      telescopes across steps instead of accumulating.
    quantize_activations -- None or "int8"/"fp8": the same codec on the
                      pipeline stage runner's activation and cotangent
                      hand-offs, a residual per edge. The loss broadcast
                      and non-float payloads stay exact.
    overlap        -- default of the gradient-sync call sites: a bucketed
                      asynchronous allreduce, fenced at the optimizer step
                      (``sync_gradients_sharded(overlap=)`` overrides it).
    bucket_bytes   -- target f32 payload of an overlap bucket.

    Only SUM reductions over float arrays take the quantized path;
    min/max/product and integer arrays use the exact wire.
    """

    quantize: str | None = None
    block_size: int = 256
    error_feedback: bool = True
    quantize_activations: str | None = None
    overlap: bool = False
    bucket_bytes: int = 25 * 1024 * 1024

    def __post_init__(self) -> None:
        if self.quantize not in _KINDS:
            raise ValueError(
                f"quantize must be one of {_KINDS}, got {self.quantize!r}"
            )
        if self.quantize_activations not in _KINDS:
            raise ValueError(
                f"quantize_activations must be one of {_KINDS}, got "
                f"{self.quantize_activations!r}"
            )
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")
        if self.bucket_bytes <= 0:
            raise ValueError("bucket_bytes must be positive")

    @property
    def enabled(self) -> bool:
        return self.quantize is not None

    def wire_kind(self) -> str:
        """The codec used on this host ("q8" or "f8")."""
        if self.quantize == "fp8" and fp8_supported():
            return "f8"
        return "q8"

    def activation_wire_config(self) -> "CollectiveConfig":
        """The config the activation codec encodes with: the same block
        size and EF policy, ``quantize`` set to the activation kind."""
        return CollectiveConfig(
            quantize=self.quantize_activations,
            block_size=self.block_size,
            error_feedback=self.error_feedback,
        )


# ---------------------------------------------------------------- the plain version
def _fp8_bits(scaled: np.ndarray) -> np.ndarray:
    """float8_e4m3fn of f32 values (round to nearest even), as uint8 bits."""
    return torch.from_numpy(np.ascontiguousarray(scaled)).to(_FP8).view(torch.uint8).numpy()


def _fp8_values(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(bits)).view(_FP8).float().numpy()


def _blocked(flat: np.ndarray, block_size: int) -> np.ndarray:
    """(nblocks, block_size) view of flat, zero-padded to a full block."""
    pad = (-flat.size) % block_size
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, dtype=flat.dtype)])
    return flat.reshape(-1, block_size)


def encode_plain(flat: np.ndarray, config: CollectiveConfig) -> tuple:
    """The reference's numpy encode of a 1-D f32 vector."""
    flat = np.asarray(flat, dtype=np.float32).reshape(-1)
    kind = config.wire_kind()
    blocks = _blocked(flat, config.block_size)
    absmax = np.max(np.abs(blocks), axis=1) if blocks.size else np.zeros(
        blocks.shape[0], np.float32
    )
    qmax = _INT8_MAX if kind == "q8" else _FP8_E4M3_MAX
    scales = (absmax / qmax).astype(np.float32)
    # All-zero blocks get scale 1 so the divide is well-defined (q == 0).
    safe = np.where(scales > 0, scales, np.float32(1.0))[:, None]
    scaled = blocks / safe
    if kind == "q8":
        q = np.clip(np.rint(scaled), -_INT8_MAX, _INT8_MAX).astype(np.int8)
    else:
        q = _fp8_bits(scaled)
    return (kind, q.reshape(-1), scales, int(flat.size))


def decode_plain(encoded) -> np.ndarray:
    """The reference's numpy decode (a plain ndarray passes through)."""
    if isinstance(encoded, np.ndarray):
        return encoded
    kind, q, scales, n = encoded
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    block_size = q.size // max(scales.size, 1)
    values = _fp8_values(q) if kind == "f8" else q.astype(np.float32)
    blocks = values.reshape(-1, block_size)
    safe = np.where(scales > 0, scales, np.float32(1.0))[:, None]
    return (blocks * safe).reshape(-1)[:n]


# ---------------------------------------------------------------- on the tensor's device
def encode_device(flat: torch.Tensor, config: CollectiveConfig) -> tuple:
    """``encode`` of a tensor on its own device: (kind, q, scales, n) with
    ``q`` (int8, or fp8 bits as uint8) and ``scales`` (f32) left there."""
    flat = flat.detach().reshape(-1).to(torch.float32)
    kind = config.wire_kind()
    n = flat.numel()
    pad = (-n) % config.block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, config.block_size)
    if blocks.numel():
        absmax = blocks.abs().amax(dim=1)
    else:
        absmax = blocks.new_zeros(blocks.shape[0])
    qmax = _INT8_MAX if kind == "q8" else _FP8_E4M3_MAX
    scales = absmax / torch.full_like(absmax, qmax)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))[:, None]
    scaled = blocks / safe
    if kind == "q8":
        q = scaled.round().clamp_(-_INT8_MAX, _INT8_MAX).to(torch.int8)
    else:
        q = scaled.to(_FP8).view(torch.uint8)
    return (kind, q.reshape(-1), scales, n)


def decode_device(encoded, device) -> torch.Tensor:
    """A wire tuple (its arrays on the host or on ``device``) decoded on
    ``device`` to a 1-D f32 tensor; a plain array or tensor is moved
    there unchanged."""
    if isinstance(encoded, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(encoded).to(device)
    kind, q, scales, n = encoded
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=device)
    q = torch.as_tensor(q).to(device)
    scales = torch.as_tensor(scales).to(device)
    block_size = q.numel() // max(scales.numel(), 1)
    values = q.view(_FP8).float() if kind == "f8" else q.float()
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))[:, None]
    return (values.reshape(-1, block_size) * safe).reshape(-1)[:n]


def to_host(encoded: tuple) -> tuple:
    """A device encoding as the wire tuple: ``q`` and ``scales`` copied to
    host numpy arrays."""
    kind, q, scales, n = encoded
    return (kind, q.cpu().numpy(), scales.cpu().numpy(), n)


# ---------------------------------------------------------------- the reference's API
def encode(flat, config: CollectiveConfig) -> tuple:
    """Encode a 1-D f32 vector into a block-scaled wire tuple. A tensor is
    encoded on its own device; a numpy array by the plain version."""
    if isinstance(flat, torch.Tensor):
        return to_host(encode_device(flat, config))
    return encode_plain(flat, config)


def decode(encoded) -> np.ndarray:
    """Decode a wire tuple to a 1-D f32 numpy vector (a plain array passes
    through); ``decode_device`` decodes on a device."""
    return decode_plain(encoded)


def wire_nbytes(encoded) -> int:
    """Payload bytes the encoding puts on the wire (q + scales)."""
    if isinstance(encoded, np.ndarray):
        return int(encoded.nbytes)
    if isinstance(encoded, torch.Tensor):
        return encoded.numel() * encoded.element_size()
    _, q, scales, _ = encoded
    return int(q.nbytes + scales.nbytes)


class ErrorFeedback:
    """Persistent quantization residuals, keyed by call site.

    ``encode(key, x)`` adds the residual the same site left last time,
    quantizes, and stores the new rounding error ``x' - deq(enc(x'))``.
    A tensor's residual stays on its device; a numpy array's is numpy. A
    shape change resets that site's residual rather than misapplying it.
    """

    def __init__(self) -> None:
        self._residuals: dict = {}

    def encode(self, key, x, config: CollectiveConfig) -> tuple:
        if isinstance(x, torch.Tensor):
            return to_host(self.encode_device(key, x, config))
        x = np.asarray(x, dtype=np.float32).reshape(-1)
        if not config.error_feedback:
            return encode_plain(x, config)
        residual = self._residuals.get(key)
        if isinstance(residual, np.ndarray) and residual.shape == x.shape:
            x = x + residual
        encoded = encode_plain(x, config)
        self._residuals[key] = x - decode_plain(encoded)
        return encoded

    def encode_device(self, key, x: torch.Tensor, config: CollectiveConfig) -> tuple:
        """``encode`` of a tensor, its encoding left on the device."""
        x = x.detach().reshape(-1).to(torch.float32)
        if not config.error_feedback:
            return encode_device(x, config)
        residual = self._residuals.get(key)
        if (isinstance(residual, torch.Tensor) and residual.shape == x.shape
                and residual.device == x.device):
            x = x + residual
        encoded = encode_device(x, config)
        self._residuals[key] = x - decode_device(encoded, x.device)
        return encoded

    def residual(self, key):
        return self._residuals.get(key)

    def residual_norm(self) -> float:
        """Sum of |residual| over every site."""
        return float(sum(
            float(r.abs().double().sum()) if isinstance(r, torch.Tensor) else np.abs(r).sum()
            for r in self._residuals.values()))

    def reset(self) -> None:
        self._residuals.clear()
