"""Tensor and expert parallelism for the transformer's blocks: Megatron's
split and the experts' split over ep, the partitioning that
``DEFAULT_RULES`` gives GSPMD in the JAX package.

wq, w_gate, w_up and the lm_head are split by columns over tp, wo and
w_down by rows; the embedding table is split over vocab; the MoE experts
are split over ep (each rank holds ``num_experts / ep`` of them), and
each expert's SwiGLU over tp as the dense one's. The model's blocks read
the step's ``TPContext`` (``current()``) and, where one is active, wrap
their products in these autograd pieces:

  * ``copy``: identity forward, all-reduce backward. Placed where a block's
    input fans out to the rank's column shards, so the input's gradient is
    whole again on every rank.
  * ``reduce``: all-reduce forward, identity backward. Sums a row split's
    partial products.
  * ``gather``: all-gather forward along the last dim, slice backward. The
    vocab-split logits are gathered whole, so any loss sees the logits the
    single-device path gives it.
  * ``expert_copy`` and ``expert_sum``: ``copy`` and ``reduce`` over ep,
    through the ep ``Wire`` (``parallel/_wire.py``), so that the same code
    runs on process-group ranks and on ranks that share a card.

With these every leaf that is not split over tp or ep gets the same,
whole gradient on every tp and ep rank. With no context the blocks run as
on one device. At tp = 1 the tp pieces still run, as collectives of one
rank; at ep = 1 the ep pieces are not called. ``calls`` counts the
collectives by mesh axis, as the kernels count launches: the pieces count
"tp" and "ep", the sharded step counts its gathers over "fsdp" and "dp".
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch

from ray_tpu_torch.parallel import _wire
from ray_tpu_torch.parallel.mesh import AXES

# Collectives issued since the counts were last set to 0, by mesh axis.
calls = {axis: 0 for axis in AXES}


def reset_calls() -> None:
    """Sets every axis's count to 0."""
    for axis in calls:
        calls[axis] = 0


@dataclasses.dataclass
class TPContext:
    """What the blocks need of the sharded step's mesh: the tp group (None
    on a mesh without a tp axis: the pieces are then identities), this
    rank's place in it, the data axes (dp, fsdp) as one group of
    ``data_ranks`` ranks with this rank's index in their dp-major order
    (the MoE routing and the masked loss run over the global batch across
    them), and the ep axis: its size, the ``Wire`` between its ranks and
    this rank's index on it, which says which experts the rank holds."""

    group: Any
    rank: int
    size: int
    data_ranks: int = 1
    ep: int = 1
    data_group: Any = None
    data_rank: int = 0
    ep_wire: Any = None
    ep_rank: int = 0


_CURRENT: contextvars.ContextVar[TPContext | None] = contextvars.ContextVar(
    "ray_tpu_torch_tp", default=None)


def current() -> TPContext | None:
    """The active context, or None outside a sharded step."""
    return _CURRENT.get()


@contextlib.contextmanager
def tensor_parallel(ctx: TPContext):
    """Runs the body with ``ctx`` as the blocks' context."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    calls["tp"] += 1
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        import torch.distributed as dist

        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        calls["tp"] += 1
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, dy):
        lo = ctx.rank * ctx.width
        return dy[..., lo:lo + ctx.width].contiguous(), None, None, None


def gather_data_ranks(x: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    """Every data rank's ``x`` stacked in dp-major order, [data_ranks,
    *x.shape]; no gradient flows back."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(ctx.data_ranks)]
    dist.all_gather(parts, x.contiguous(), group=ctx.data_group)
    calls["dp"] += 1
    return torch.stack(parts)


def data_rank_sum(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(``x`` summed over the data ranks of the active context, their
    count); (x, 1) where there is one data rank or no context. No gradient
    flows back."""
    ctx = current()
    if ctx is None or ctx.data_ranks == 1:
        return x, 1
    import torch.distributed as dist

    out = x.detach().clone()
    dist.all_reduce(out, group=ctx.data_group)
    calls["dp"] += 1
    return out, ctx.data_ranks


def copy(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, all-reduce over tp backward; x itself outside a
    context."""
    ctx = current()
    return x if ctx is None or ctx.group is None else _Copy.apply(x, ctx.group)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """All-reduce over tp forward, identity backward; x itself outside a
    context."""
    ctx = current()
    return x if ctx is None or ctx.group is None else _Reduce.apply(x, ctx.group)


def gather(x: torch.Tensor) -> torch.Tensor:
    """The tp ranks' shards of the last dim concatenated in rank order;
    the backward keeps this rank's slice. x itself outside a context."""
    ctx = current()
    if ctx is None or ctx.group is None:
        return x
    return _Gather.apply(x, ctx.group, ctx.rank, ctx.size)


def local_heads(ctx: TPContext | None, n_heads: int, heads: int) -> tuple[int, int]:
    """(first head, heads) of this rank's share of ``n_heads``, where
    ``heads`` is the count in its wq columns. Raises when tp does not
    split the heads evenly: GSPMD pads, the port refuses (ROADMAP Queue
    C)."""
    if ctx is None or ctx.group is None:
        return 0, n_heads
    if heads * ctx.size != n_heads:
        raise ValueError(
            f"tp={ctx.size} does not divide n_heads={n_heads}: the port does not pad uneven "
            "tensor-parallel shards (ROADMAP Queue C)"
        )
    return ctx.rank * heads, heads


def local_experts(ctx: TPContext | None, num_experts: int, held: int) -> tuple[int, int]:
    """(first expert, experts) of this rank's share of ``num_experts``,
    where ``held`` is the count in its expert leaves. Raises when ep does
    not split the experts evenly, as the reference's planner does (ROADMAP
    Queue C item 7)."""
    ep = 1 if ctx is None else ctx.ep
    if held * ep != num_experts:
        raise NotImplementedError(
            f"ep={ep} with {held} experts a rank for num_experts={num_experts}: the port "
            "splits the experts evenly over ep and does not pad them (ROADMAP Queue A item "
            "4b, Queue C item 7)"
        )
    return (0 if ctx is None else ctx.ep_rank) * held, held


def expert_copy(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, sum over ep backward (where each ep rank's work
    after x covers its own experts); x itself outside a context or at ep 1."""
    ctx = current()
    if ctx is None or ctx.ep == 1:
        return x
    calls["ep"] += 1
    return _wire.sum_cotangents(x, ctx.ep_wire)


def expert_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ep forward, identity backward: the combine's contraction
    over the experts, each ep rank's part summed. x itself outside a
    context or at ep 1."""
    ctx = current()
    if ctx is None or ctx.ep == 1:
        return x
    calls["ep"] += 1
    return _wire.all_reduce_replicated(x, ctx.ep_wire)
