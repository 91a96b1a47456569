"""The wire between the ranks of one mesh axis, and the differentiable
collectives built on it.

Ring attention, Ulysses attention, ``pipeline_apply`` and the stage runner
reach the other ranks only through a ``Wire``: a neighbour shift (the
counterpart of ``ppermute``), a tiled all-to-all, a sum, a broadcast and
point-to-point send and receive. ``ProcessGroupWire`` implements it over a
``torch.distributed`` group: NCCL on the card, gloo on the CPU. Another
implementation (ranks as threads of one process on one card, say) plugs in
through a mesh with a ``wire(axis)`` method (``axis_wire``).

On top of it, four ``torch.autograd.Function``s:

  * ``shift(x, wire, offset)``: x goes to rank + offset, the result comes
    from rank - offset; the backward is the reverse shift;
  * ``all_to_all(x, wire, split_dim, concat_dim)``: ``jax.lax.all_to_all``
    with ``tiled=True``; the backward is the inverse exchange;
  * ``all_reduce_replicated(x, wire)``: the sum over the ranks, whose
    backward passes each rank's cotangent through unchanged: every rank
    computes what follows alike, so each holds the whole cotangent;
  * ``sum_cotangents(x, wire)``: x itself, whose backward sums the ranks'
    cotangents: where each rank's work after x is its part of a sum (its
    experts), x's cotangent and everything's before it is whole again.

Every rank must make the same calls in the same order, forward and
backward alike.
"""

from __future__ import annotations

from typing import Any

import torch


class Wire:
    """What the sequence- and pipeline-parallel code asks of the ranks of
    one mesh axis. ``rank`` and ``size`` are the axis's."""

    rank: int = 0
    size: int = 1

    def shift(self, tensors: list[torch.Tensor], offset: int = 1) -> list[torch.Tensor]:
        """Sends each tensor to rank + offset and returns those that rank -
        offset sent (mod size), in one exchange."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x: [size, ...]; piece i goes to rank i. Returns [size, ...]
        whose piece j came from rank j."""
        raise NotImplementedError

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the ranks, as a new tensor."""
        raise NotImplementedError

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank src's x on every rank, as a new tensor."""
        raise NotImplementedError

    def send(self, x: torch.Tensor, dst: int) -> None:
        """Posts x to rank dst without waiting for it to be taken."""
        raise NotImplementedError

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """The next tensor rank src sent here, shaped, typed and placed like
        ``like``. Messages on one (src, dst) edge arrive in the order they
        were sent."""
        raise NotImplementedError

    def flush(self) -> None:
        """Waits until every tensor this rank sent has been taken."""


class _OneRank(Wire):
    """The wire of an axis of size 1 (or absent from the mesh): every
    exchange hands the rank its own tensors."""

    def shift(self, tensors, offset=1):
        return [t.clone() for t in tensors]

    def all_to_all(self, x):
        return x.clone()

    def all_reduce(self, x):
        return x.clone()

    def broadcast(self, x, src):
        return x.clone()


class ProcessGroupWire(Wire):
    """A ``Wire`` over a ``torch.distributed`` process group (``None``: the
    world). A shift posts its sends and receives as one
    ``batch_isend_irecv``: a blocking send followed by a receive on every
    rank would deadlock on NCCL. ``send`` and ``recv`` use a group of their
    own for each directed edge between ring neighbours (``point_to_point``),
    created at construction by the two ranks of each edge: NCCL serializes
    the operations of one communicator, so two ranks sending to each other
    on a shared one would each wait for the other's receive behind its own
    send."""

    def __init__(self, group=None, *, point_to_point: bool = False):
        import torch.distributed as dist

        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._global = [dist.get_global_rank(group, r) if group is not None else r
                        for r in range(self.size)]
        self._pending: list = []
        self._edges: dict[tuple[int, int], Any] = {}
        if point_to_point and self.size > 1:
            edges = sorted({(a, (a + d) % self.size) for a in range(self.size) for d in (1, -1)})
            for a, b in edges:
                if self.rank in (a, b):
                    self._edges[(a, b)] = dist.new_group(
                        sorted({self._global[a], self._global[b]}),
                        use_local_synchronization=True)

    def shift(self, tensors, offset=1):
        import torch.distributed as dist

        dst = self._global[(self.rank + offset) % self.size]
        src = self._global[(self.rank - offset) % self.size]
        sends = [t.contiguous() for t in tensors]
        outs = [torch.empty_like(t) for t in sends]
        ops = []
        for t, out in zip(sends, outs):
            ops.append(dist.P2POp(dist.isend, t, dst, self.group))
            ops.append(dist.P2POp(dist.irecv, out, src, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return outs

    def all_to_all(self, x):
        import torch.distributed as dist

        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_reduce(self, x):
        import torch.distributed as dist

        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def broadcast(self, x, src):
        import torch.distributed as dist

        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=self._global[src], group=self.group)
        return out

    def _edge(self, a: int, b: int):
        if (a, b) not in self._edges:
            raise ValueError(f"no point-to-point edge {a}->{b}: build the wire with "
                             f"point_to_point=True; edges join ring neighbours only")
        return self._edges[(a, b)]

    def send(self, x, dst):
        import torch.distributed as dist

        x = x.detach().contiguous()
        self._pending.append((dist.isend(x, self._global[dst], group=self._edge(self.rank, dst)),
                              x))

    def recv(self, like, src):
        import torch.distributed as dist

        out = torch.empty_like(like)
        dist.irecv(out, self._global[src], group=self._edge(src, self.rank)).wait()
        return out

    def flush(self):
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()


# The envelope of a codec-compressed payload on a group wire: (marker, shape,
# dtype, wire tuple), as the reference's activation wire.
_ACT_WIRE = "__act"


class GroupWire(Wire):
    """A ``Wire`` over a host-memory collective group (the ``ring``, or a
    ``hier`` group's ring tier): ``send`` and ``recv`` are the group's
    tagged messages, paired in order on each edge; ``broadcast`` is the
    group's, exact. With ``codec`` (a ``CollectiveConfig`` whose
    ``quantize`` names the kind, the activation wire config) a float
    tensor sent with a ``site`` crosses block-scale quantized through the
    wire's ``ErrorFeedback`` (one residual a site), as the reference's
    stage runner quantizes its activations and cotangents; other payloads
    stay exact."""

    TAG = "pp"
    # A stage's receive waits up to this long, as the reference runner's.
    RECV_TIMEOUT_S = 120.0

    def __init__(self, group, *, codec=None):
        from ray_tpu_torch.util.collective.quantization import ErrorFeedback

        self.group, self.rank, self.size = group, group.rank, group.world_size
        self.codec, self.ef = codec, ErrorFeedback()

    def send(self, x, dst, site=None):
        from ray_tpu_torch.util.collective import flight

        payload = x
        if (self.codec is not None and site is not None and isinstance(x, torch.Tensor)
                and x.is_floating_point()):
            payload = (_ACT_WIRE, tuple(x.shape), str(x.dtype).split(".")[-1],
                       self.ef.encode(site, x, self.codec))
        with flight.site("pipeline"):
            self.group.send(payload, dst, tag=self.TAG)

    def recv(self, like, src):
        from ray_tpu_torch.util.collective import flight
        from ray_tpu_torch.util.collective.quantization import decode_device

        with flight.site("pipeline"):
            data = self.group.recv(src, tag=self.TAG, timeout=self.RECV_TIMEOUT_S)
        if isinstance(data, tuple) and len(data) == 4 and data[0] == _ACT_WIRE:
            _, shape, dtype, enc = data
            return decode_device(enc, like.device).reshape(shape).to(getattr(torch, dtype))
        if isinstance(data, tuple):  # a tensor numpy has no dtype for
            from ray_tpu_torch.util.collective.collective import _tensor_of

            return _tensor_of(data, like.device)
        return torch.from_numpy(data).to(like.device)

    def broadcast(self, x, src):
        return self.group.broadcast(x.detach(), src_rank=src).clone()


def axis_wire(mesh: Any, axis: str) -> Wire:
    """The wire of ``mesh``'s ``axis``: the mesh's own (``mesh.wire(axis)``)
    when it has one, else a ``ProcessGroupWire`` over the ``DeviceMesh``'s
    group of that axis. An axis the mesh lacks, or of size 1, is a wire of
    one rank."""
    if hasattr(mesh, "wire"):
        return mesh.wire(axis)
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names or mesh.size(names.index(axis)) == 1:
        return _OneRank()
    return ProcessGroupWire(mesh.get_group(axis))


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wire, offset):
        ctx.wire, ctx.offset = wire, offset
        return wire.shift([x.detach()], offset)[0]

    @staticmethod
    def backward(ctx, g):
        return ctx.wire.shift([g.contiguous()], -ctx.offset)[0], None, None


def shift(x: torch.Tensor, wire: Wire, offset: int = 1) -> torch.Tensor:
    """x sent to rank + offset; returns what rank - offset sent. The
    backward sends the cotangent back the other way."""
    return _Shift.apply(x, wire, offset)


def _exchange(x: torch.Tensor, wire: Wire, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all: x split into ``size`` blocks along split_dim,
    block i to rank i; the blocks received, in rank order, concatenated
    along concat_dim."""
    pieces = torch.stack(x.chunk(wire.size, dim=split_dim))
    received = wire.all_to_all(pieces)
    return torch.cat(received.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wire, split_dim, concat_dim):
        if x.shape[split_dim] % wire.size:
            raise ValueError(f"all_to_all splits dim {split_dim} of size {x.shape[split_dim]} "
                             f"over {wire.size} ranks")
        ctx.wire, ctx.dims = wire, (split_dim, concat_dim)
        return _exchange(x.detach(), wire, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _exchange(g, ctx.wire, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, wire: Wire, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``;
    the backward is the inverse exchange."""
    return _AllToAll.apply(x, wire, split_dim, concat_dim)


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wire):
        return wire.all_reduce(x.detach())

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_replicated(x: torch.Tensor, wire: Wire) -> torch.Tensor:
    """The sum of x over the ranks; the backward hands each rank's
    cotangent through unchanged (what follows runs alike on every rank)."""
    return _AllReduceReplicated.apply(x, wire)


class _SumCotangents(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wire):
        ctx.wire = wire
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.wire.all_reduce(g.contiguous()), None


def sum_cotangents(x: torch.Tensor, wire: Wire) -> torch.Tensor:
    """x itself; the backward sums the ranks' cotangents of x (the
    counterpart of ``all_reduce_replicated``, as tp's ``copy`` is of its
    ``reduce``)."""
    return _SumCotangents.apply(x, wire)
