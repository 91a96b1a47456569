"""Rotary position embeddings (RoPE), split-halves convention.

Plain PyTorch: an elementwise pass over q and k that reads two small f32
tables. The rotation pairs element i with element i + head_dim / 2 (the two
halves of the last axis), not neighbouring pairs.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import resolve_device


def rope_frequencies(
    head_dim: int, max_seq: int, theta: float = 10000.0, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns f32 (cos, sin) tables of shape [max_seq, head_dim // 2]."""
    device = resolve_device(device)
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def clamp_index(index: torch.Tensor, size: int) -> torch.Tensor:
    """Index rule of a JAX gather: negative indices wrap once, then every
    index clamps into [0, size - 1], so no id can fault a device gather."""
    index = index.long()
    index = torch.where(index < 0, index + size, index)
    return index.clamp(0, size - 1)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """x: [batch, heads, seq, head_dim]; cos/sin: [max_seq, head_dim // 2].

    positions: optional [batch, seq] absolute positions (KV-cache decode).
    An out-of-range position takes the table's last row. Math in f32, cast
    back to x's dtype.
    """
    seq = x.shape[-2]
    if positions is None:
        c = cos[:seq][None, None, :, :]
        s = sin[:seq][None, None, :, :]
    else:
        idx = clamp_index(torch.as_tensor(positions).to(cos.device), cos.shape[0])
        c = cos[idx][:, None, :, :]
        s = sin[idx][:, None, :, :]
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return rotated.to(x.dtype)
