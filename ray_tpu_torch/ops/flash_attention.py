"""Flash attention forward: a hand-written CUDA kernel
(``csrc/flash_attention_fwd.cu``) and its plain version.

``flash_attention`` launches the kernel for CUDA tensors and uses the plain
``attention_reference`` only for tensors on the CPU. The causal mask is
aligned to the END of the keys (``causal_offset = seq_k - seq_q``, the
decode convention), and masked scores are -1e30, not -inf.

Only the forward pass exists: the backward kernels are not ported yet, so
an input that requires grad raises ``NotImplementedError`` rather than
giving a result with no gradient.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import _build

_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (32, 64, 128)


def _causal_mask(seq_q: int, seq_k: int, device) -> torch.Tensor:
    """True where query i may see key j: j <= i + (seq_k - seq_q)."""
    return torch.ones(seq_q, seq_k, dtype=torch.bool, device=device).tril(seq_k - seq_q)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention over [batch, heads, seq, head_dim]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        mask = _causal_mask(s.shape[-2], s.shape[-1], s.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _lse_reference(
    q: torch.Tensor, k: torch.Tensor, *, causal: bool, scale: float
) -> torch.Tensor:
    """f32 log-sum-exp of the masked scores, [batch, heads, seq_q]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(s.shape[-2], s.shape[-1], s.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return torch.logsumexp(s, dim=-1)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention has no backward yet: call it under "
            "torch.inference_mode() or on tensors that do not require grad"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, heads, seq, head_dim]")
    if k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError("repeat kv heads before calling (GQA)")


def _flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (O [batch, heads, seq_q, head_dim] in q's dtype,
    LSE [batch, heads, seq_q] f32). The LSE is what a backward needs."""
    _check_inputs(q, k, v)
    batch, heads, seq_q, dim = q.shape
    seq_k = k.shape[2]
    if scale is None:
        scale = dim ** -0.5
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return (
            attention_reference(q, k, v, causal=causal, scale=scale),
            _lse_reference(q, k, causal=causal, scale=scale),
        )
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes f32 or bf16 of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if dim not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_KERNEL_HEAD_DIMS}, got {dim}")
    q, k, v = (_build.contiguous_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(batch, heads, seq_q, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _build.launch(
        "rt_flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        batch * heads, seq_q, seq_k, dim, int(q.dtype == torch.bfloat16),
        int(causal), float(scale),
    )
    flash_attention.launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """q, k, v: [batch, heads, seq, head_dim] (kv heads repeated to q's by
    the caller). Returns O, shaped and typed like q."""
    return _flash_forward(q, k, v, causal=causal, scale=scale)[0]


# Kernel launches since the count was last set to 0.
flash_attention.launches = 0
