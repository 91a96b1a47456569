"""Ring and Ulysses attention: sequence (context) parallelism over the
``sp`` mesh axis, on the flash kernels.

Port of ray_tpu's ``parallel/ring_attention.py``. Both return an
``attention_fn(q, k, v, causal)`` for ``TransformerConfig.attention``.
Each rank holds its shard of q, k and v, [batch, heads, seq / sp,
head_dim]: its rows of the batch axes and its heads of the head axis as
well, which need no exchange here (``batch_axes`` and ``head_axis`` keep
the reference's signature; only ``seq_axis`` talks to other ranks). Rank
r's shard holds global positions r * seq_local onwards
(``sequence_positions`` gives them to the model's RoPE).

  * Ring: K and V rotate around the ``sp`` ring while each rank attends
    its queries to the chunk it holds, and the chunks' outputs merge by
    their log-sum-exp into an f32 O and LSE. Per step, the chunk of the
    rank's own shard runs causal, chunks of earlier ranks in full, and
    under ``causal`` the chunks of later ranks are skipped (the
    reference's mask zeroes them). A chunk is the flash forward kernel
    (``_flash_forward``, which returns the LSE). The backward runs the dQ
    and dK/dV kernels on each chunk with the merged O and LSE, which give
    each chunk's share of the whole softmax; the dK/dV accumulators ride
    the ring with K and V, plus one last hop home. On CPU tensors the same
    loop runs the plain versions beside the kernels.
  * Ulysses: a tiled all-to-all trades the sequence split for a head split,
    the port's ``flash_attention`` runs over the whole sequence, and a
    second all-to-all trades back. Heads must divide by ``sp``.

The output is in q's dtype, as the reference's.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.ops import flash_attention as flash
from ray_tpu_torch.parallel import _wire


def _merge(out, lse, out_c, lse_c):
    """The LSE merge of a running (f32 O, LSE) with one chunk's."""
    if out is None:
        return out_c.float(), lse_c
    new = torch.logaddexp(lse, lse_c)
    out = out * torch.exp(lse - new)[..., None] + out_c.float() * torch.exp(lse_c - new)[..., None]
    return out, new


def _chunk_causal(causal: bool, src: int, rank: int) -> bool | None:
    """How the chunk from rank ``src`` runs for rank ``rank``'s queries:
    True (causal, the diagonal), False (in full) or None (skipped)."""
    if not causal:
        return False
    if src == rank:
        return True
    return False if src < rank else None


def _ring_forward(q, k, v, wire, causal: bool, scale: float):
    """(O in q's dtype, LSE f32) of q's shard against the whole sequence."""
    out = lse = None
    k_cur, v_cur = k, v
    for step in range(wire.size):
        src = (wire.rank - step) % wire.size
        mode = _chunk_causal(causal, src, wire.rank)
        if mode is not None:
            out_c, lse_c = flash._flash_forward(q, k_cur, v_cur, causal=mode, scale=scale)
            out, lse = _merge(out, lse, out_c, lse_c)
        if step < wire.size - 1:
            k_cur, v_cur = wire.shift([k_cur, v_cur])
    return out.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, do, wire, causal: bool, scale: float):
    """(dQ, dK, dV) of q's, k's and v's shards. The dK/dV accumulators
    travel with the chunk they belong to and reach its rank on the last
    hop."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k, v
    for step in range(wire.size):
        src = (wire.rank - step) % wire.size
        mode = _chunk_causal(causal, src, wire.rank)
        if mode is not None:
            dq_c, dk_c, dv_c = flash._flash_backward(
                q, k_cur, v_cur, out, lse, do, causal=mode, scale=scale)
            dq += dq_c.float()
            dk += dk_c.float()
            dv += dv_c.float()
        if step < wire.size - 1:
            k_cur, v_cur, dk, dv = wire.shift([k_cur, v_cur, dk, dv])
        else:
            dk, dv = wire.shift([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """Saves q, k, v and the merged O and LSE; the backward re-runs the
    ring."""

    @staticmethod
    def forward(ctx, q, k, v, wire, causal: bool, scale: float):
        out, lse = _ring_forward(q, k, v, wire, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.wire, ctx.causal, ctx.scale = wire, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, do.contiguous(), ctx.wire, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wire: _wire.Wire,
                   causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Attention of this rank's sequence shard of q against every rank's
    k and v shards, over ``wire``'s ring. Differentiable in q, k and v."""
    flash._check_inputs(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, wire, bool(causal), float(scale))


def make_ring_attention(
    mesh: Any,
    *,
    batch_axes=("dp", "fsdp"),
    head_axis="tp",
    seq_axis="sp",
) -> Callable:
    """Returns attention_fn(q, k, v, causal) for TransformerConfig.attention.
    Arrays are this rank's [batch, heads, seq / sp, head_dim] shards."""
    wire = _wire.axis_wire(mesh, seq_axis)

    def attention_fn(q, k, v, causal):
        return ring_attention(q, k, v, wire, causal)

    return attention_fn


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wire: _wire.Wire,
                      causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Sequence-sharded [B, H, S/n, D] to head-sharded [B, H/n, S, D],
    flash attention over the whole sequence, then back."""
    flash._check_inputs(q, k, v)
    if q.shape[1] % wire.size:
        raise ValueError(f"Ulysses needs heads ({q.shape[1]}) divisible by the sp axis "
                         f"({wire.size})")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qh, kh, vh = (_wire.all_to_all(t, wire, 1, 2) for t in (q, k, v))
    out = flash.flash_attention(qh, kh, vh, causal=causal, scale=scale)
    return _wire.all_to_all(out.to(q.dtype), wire, 2, 1)


def make_ulysses_attention(
    mesh: Any,
    *,
    batch_axes=("dp", "fsdp"),
    head_axis="tp",
    seq_axis="sp",
) -> Callable:
    """Ulysses-style SP: heads must be divisible by the sp axis size."""
    wire = _wire.axis_wire(mesh, seq_axis)

    def attention_fn(q, k, v, causal):
        return ulysses_attention(q, k, v, wire, causal)

    return attention_fn


def sequence_positions(mesh: Any, batch: int, seq_local: int, *, seq_axis: str = "sp",
                       device=None) -> torch.Tensor:
    """[batch, seq_local] global positions of this rank's sequence shard:
    ``sp_rank * seq_local + arange(seq_local)``, for ``forward``'s
    ``positions``."""
    start = _wire.axis_wire(mesh, seq_axis).rank * seq_local
    pos = torch.arange(start, start + seq_local, device=device)
    return pos.expand(batch, seq_local)
