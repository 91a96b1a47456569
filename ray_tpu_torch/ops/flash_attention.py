"""Flash attention, forward and backward: hand-written CUDA kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/flash_fwd_wgmma.cu``, ``csrc/flash_bwd_dq_wgmma.cu``,
``csrc/flash_bwd_dkv_wgmma.cu``) and their plain versions.

Two routes, chosen by (dtype, head_dim) in the C entry points: bf16 at
head_dim 128, every shape the model gives the kernels, takes the forward,
dQ and dK/dV kernels built on TMA and ``wgmma``; f32, bf16 and f16 at
head_dim 16, 32, 64 and 256, and f32 and f16 at 128, take the ``mma.sync``
kernels (at 256 each block computes half of the output's columns), and so
does every dtype at a head_dim above 256 (``flash_attention_wide.cu``: a
block per 128-column slice of the output, the scores summed over the head
in 128-column chunks). The kernels are built for head_dim 16, 32, 64, 128
and 256 and for every multiple of 128 above 256; any other head_dim is
zero-padded on the last axis to the next of those (``padded_head_dim``),
run with the scale of the true head_dim and sliced back. That is exact:
zero columns add nothing to Q K^T, to rowsum(dO * O) or to dP, and give
zero columns of O, dQ, dK and dV. The entry points report the route they
launched and the wrappers count launches by it; ``kernel_route`` states
the rule, and ``chip_smoke.py`` holds every reported route against it. A
launch error on either route raises.

``flash_attention`` is differentiable through ``_FlashAttention``, the
counterpart of the JAX package's ``_flash_vjp``: the forward saves
(q, k, v, O, LSE) and the backward recomputes P tile by tile in the dQ and
dK/dV kernels. For CUDA tensors both passes launch the kernels; the plain
``attention_reference`` and ``_flash_backward_reference`` serve only
tensors on the CPU. The causal mask is aligned to the END of the keys
(``causal_offset = seq_k - seq_q``, the decode convention), and masked
scores are -1e30, not -inf.

A query row that sees no key (causal with seq_q > seq_k) gets equal
weights over every key, as ``attention_reference`` gives it. Its gradient is
that function's derivative: its dQ and its share of dK are zero (its masked
scores do not depend on q or k) and it adds dO / seq_k to every dV row.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ray_tpu_torch import _build

_NEG_INF = -1e30
# The head_dims up to 256 the kernels are built for; above 256 every
# multiple of _WIDE_STEP.
_KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
_WIDE_STEP = 128


def padded_head_dim(head_dim: int) -> int:
    """The head_dim the kernels run ``head_dim`` at: the least built size
    (16, 32, 64, 128 or 256, or a multiple of 128 above 256) that holds
    it."""
    if head_dim <= 0:
        raise ValueError(f"flash kernels take a positive head_dim, got {head_dim}")
    for size in _KERNEL_HEAD_DIMS:
        if head_dim <= size:
            return size
    return -(-head_dim // _WIDE_STEP) * _WIDE_STEP


def _pad_head(t: torch.Tensor, size: int) -> torch.Tensor:
    """t with zero columns appended on the last axis up to ``size``."""
    extra = size - t.shape[-1]
    return F.pad(t, (0, extra)) if extra else t


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels ``rt_flash_fwd``, ``rt_flash_bwd_dq`` and
    ``rt_flash_bwd_dkv`` launch for inputs of this dtype and head_dim:
    "wgmma" (TMA and wgmma) for bf16 at a padded head_dim of 128, else
    "mma_sync" (bf16 at 256 and above included)."""
    size = padded_head_dim(head_dim)
    return "wgmma" if dtype == torch.bfloat16 and size == 128 else "mma_sync"


# The route codes the C entry points report (kRouteMmaSync, kRouteWgmma).
_ROUTES = ("mma_sync", "wgmma")


def _count(fn, route: ctypes.c_int) -> None:
    """Counts one launch of fn's kernel, on the route its entry point reported."""
    fn.launches += 1
    fn.launches_by_route[_ROUTES[route.value]] += 1


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


def _flash_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' formulas on whole tensors: (dQ, dK, dV) in the dtypes
    of q, k and v. P and dS are cast to q's dtype before their products;
    every sum is f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    do = do.to(q.dtype)
    dof = do.float()
    delta = (dof * out.float()).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = p * (dp - delta) * scale
    if causal:
        seq_q, seq_k = s.shape[-2:]
        mask = _causal_mask(seq_q, seq_k, s.device)
        sees_none = ~mask.any(-1, keepdim=True)  # rows that see no key
        p = torch.where(mask, p, 0.0)
        p = torch.where(sees_none, torch.full_like(p, 1.0 / seq_k), p)
        ds = torch.where(mask, ds, 0.0)
    p = p.to(q.dtype).float()
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, heads, seq, head_dim]")
    if k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError("repeat kv heads before calling (GQA)")


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """What the CUDA kernels take; raises on anything else. Returns the
    head_dim the kernels run at."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes f32, bf16 or f16 of one dtype, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    return padded_head_dim(q.shape[-1])


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
    size = _check_kernel_inputs(q, k, v)
    q, k, v = (_build.contiguous_aligned(_pad_head(t, size)) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(batch, heads, seq_q, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out[..., :dim], lse
    route = ctypes.c_int(-1)
    _build.launch(
        "rt_flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        batch * heads, seq_q, seq_k, size, _build.DTYPE_CODES[q.dtype],
        int(causal), float(scale), ctypes.byref(route),
    )
    _count(flash_attention, route)
    return out[..., :dim], lse


def _flash_bwd_dq(q, k, v, out, do, lse, delta, dq, causal: bool, scale: float) -> None:
    """Launches the dQ kernel, which also writes delta = rowsum(dO * O)."""
    batch, heads, seq_q, dim = q.shape
    route = ctypes.c_int(-1)
    _build.launch(
        "rt_flash_bwd_dq", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        batch * heads, seq_q, k.shape[2], dim, _build.DTYPE_CODES[q.dtype],
        int(causal), float(scale), ctypes.byref(route),
    )
    _count(_flash_bwd_dq, route)


def _flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, causal: bool, scale: float) -> None:
    """Launches the dK/dV kernel; delta comes from the dQ kernel."""
    batch, heads, seq_q, dim = q.shape
    route = ctypes.c_int(-1)
    _build.launch(
        "rt_flash_bwd_dkv", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        batch * heads, seq_q, k.shape[2], dim, _build.DTYPE_CODES[q.dtype],
        int(causal), float(scale), ctypes.byref(route),
    )
    _count(_flash_bwd_dkv, route)


def _flash_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of flash attention from the forward's O and LSE and the
    output's gradient dO, in the dtypes of q, k and v. dO is cast to q's
    dtype first, as the JAX package does, before delta and both kernels."""
    _check_inputs(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    do = do.to(q.dtype)
    if all(t.device.type == "cpu" for t in (q, k, v, out, lse, do)):
        return _flash_backward_reference(q, k, v, out, lse, do, causal=causal, scale=scale)
    size = _check_kernel_inputs(q, k, v)
    if out.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(
            f"flash backward: O {tuple(out.shape)}, dO {tuple(do.shape)}, "
            f"LSE {tuple(lse.shape)} for q {tuple(q.shape)}"
        )
    if lse.dtype != torch.float32 or any(t.device != q.device for t in (out, lse, do)):
        raise ValueError("flash backward: LSE must be f32 and O, LSE, dO on q's device")
    dim = q.shape[-1]
    q, k, v, out, do = (
        _build.contiguous_aligned(_pad_head(t, size)) for t in (q, k, v, out, do)
    )
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq[..., :dim].zero_(), dk[..., :dim].zero_(), dv[..., :dim].zero_()
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _flash_bwd_dq(q, k, v, out, do, lse, delta, dq, causal, scale)
    _flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, causal, scale)
    return dq[..., :dim], dk[..., :dim], dv[..., :dim]


class _FlashAttention(torch.autograd.Function):
    """Mirrors the JAX package's ``_flash_vjp``: saves (q, k, v, O, LSE)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.device.type == "cuda":  # save the copies the kernels read
            q, k, v = (_build.contiguous_aligned(t) for t in (q, k, v))
        out, lse = _flash_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, do, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """q, k, v: [batch, heads, seq, head_dim] (kv heads repeated to q's by
    the caller). Returns O, shaped and typed like q; differentiable in q,
    k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, float(scale))


def reset_launch_counts() -> None:
    """Sets every launch count of this module to 0."""
    for fn in (flash_attention, _flash_bwd_dq, _flash_bwd_dkv):
        fn.launches = 0
        fn.launches_by_route = {"wgmma": 0, "mma_sync": 0}


# Kernel launches since the counts were last set to 0, in all and by route:
# the forward kernel, and the backward's dQ and dK/dV kernels.
reset_launch_counts()
