"""Collective groups over ``torch.distributed``: NCCL on the card, gloo on
the CPU.

Port of ray_tpu's ``util/collective/collective.py``: its ``XlaGroup``
(device collectives across the ranks of one distributed runtime) becomes
``NcclGroup``, with the same ops, arguments and return shapes, and the
module keeps ``init_collective_group`` / ``get_group`` /
``destroy_collective_group`` and the module-level ops. Each rank
contributes one array (numpy or a tensor) and gets the result in the same
kind: numpy in, numpy out; a tensor in, a tensor on the group's device out.
A group of one rank returns its input, as the reference's does.

  * ``allreduce(array, op)``: SUM, PRODUCT, MIN or MAX. A PRODUCT of bf16
    or f16 is taken in f32 and rounded once: NCCL does not take a bf16
    product on every version;
  * ``allgather(array)``: a list of world-size arrays, in rank order;
  * ``broadcast(array, src_rank)``;
  * ``reducescatter(array, op)``: ``np.array_split(reduced.reshape(-1),
    world)[rank]``. NCCL's reduce-scatter takes equal chunks, so the
    uneven chunks of ``array_split`` are padded to the largest and sliced
    back;
  * ``barrier()``;
  * ``p2p(array, src_rank, dst_rank)``, a paired op every rank enters
    (bystanders pass a template), and ``send`` / ``recv(like=...)``.

The group runs on the process group of the process (the gang's world, or
a one-rank group it starts itself). Out of this port: the ``ring``
backend and its quantized wire, which talk through the controller's
key-value store (runtime, not ported), and the ``hier`` backend (ROADMAP
Queue A item 4a). A group that cannot form raises.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

SUM, PRODUCT, MIN, MAX = "sum", "product", "min", "max"

_groups: dict[str, "NcclGroup"] = {}


def _reduce_op(op: str):
    import torch.distributed as dist

    ops = {SUM: dist.ReduceOp.SUM, PRODUCT: dist.ReduceOp.PRODUCT, MIN: dist.ReduceOp.MIN,
           MAX: dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"collective op {op!r} is none of {sorted(ops)}")
    return ops[op]


class NcclGroup:
    """Elementwise collectives across the ranks of this process group (see
    the module docstring). ``backend`` is "nccl" (the card, the default) or
    "gloo" (the CPU); an initialized process group must have that backend,
    ``world_size`` ranks and this ``rank``. Without one, a group of one
    rank starts its own (rendezvous in a temporary directory); a larger
    one starts from ``MASTER_ADDR`` / ``MASTER_PORT``, as the gang sets
    them."""

    def __init__(self, world_size: int, rank: int, group_name: str, config: Any = None, *,
                 backend: str = "nccl"):
        import torch.distributed as dist

        if backend not in ("nccl", "gloo"):
            raise ValueError(f"collective backend {backend!r}: the port has 'nccl' (the card) "
                             "and 'gloo' (the CPU); 'ring' is runtime, not ported, and 'hier' "
                             "waits for ROADMAP Queue A item 4a")
        if backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError("an NCCL collective group needs a CUDA device; pass "
                               "backend='gloo' for the CPU")
        self.world_size, self.rank, self.group_name = int(world_size), int(rank), group_name
        self.backend_name = backend
        # Accepted for the reference's signature; the device wire has no
        # quantized format here.
        self.config = config
        self._owns_process_group = False
        if not dist.is_initialized():
            if backend == "nccl":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) %
                                      torch.cuda.device_count())
            if self.world_size == 1:
                store = dist.FileStore(os.path.join(
                    tempfile.mkdtemp(prefix="ray_tpu_torch_collective_"), "store"), 1)
                dist.init_process_group(backend, store=store, rank=0, world_size=1)
            else:
                dist.init_process_group(backend, init_method="env://", rank=self.rank,
                                        world_size=self.world_size)
            self._owns_process_group = True
        if dist.get_backend() != backend:
            raise RuntimeError(f"collective group {group_name!r} asks for {backend}, the "
                               f"process group runs {dist.get_backend()}")
        if dist.get_world_size() != self.world_size or dist.get_rank() != self.rank:
            raise RuntimeError(
                f"collective group {group_name!r}: rank {self.rank} of {self.world_size}, but "
                f"the process group is rank {dist.get_rank()} of {dist.get_world_size()}")
        self.device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                       else torch.device("cpu"))

    # -- conversions: each op answers in the kind it was given ------------
    def _tensor(self, array) -> torch.Tensor:
        if isinstance(array, torch.Tensor):
            return array.detach().to(self.device).contiguous().clone()
        return torch.from_numpy(np.array(array)).to(self.device)

    @staticmethod
    def _back(t: torch.Tensor, like):
        if isinstance(like, torch.Tensor):
            return t
        return t.cpu().numpy()

    def _all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        import torch.distributed as dist

        if op == PRODUCT and t.dtype in (torch.bfloat16, torch.float16):
            wide = t.float()
            dist.all_reduce(wide, op=_reduce_op(op))
            return wide.to(t.dtype)
        dist.all_reduce(t, op=_reduce_op(op))
        return t

    # -- the reference's ops ------------------------------------------------
    def allreduce(self, array, op: str = SUM):
        _reduce_op(op)
        if self.world_size == 1:
            return array if isinstance(array, torch.Tensor) else np.asarray(array)
        return self._back(self._all_reduce(self._tensor(array), op), array)

    def allgather(self, array) -> list:
        import torch.distributed as dist

        if self.world_size == 1:
            return [array if isinstance(array, torch.Tensor) else np.asarray(array)]
        t = self._tensor(array)
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t)
        return [self._back(p, array) for p in parts]

    def broadcast(self, array, src_rank: int = 0):
        import torch.distributed as dist

        if self.world_size == 1:
            return array if isinstance(array, torch.Tensor) else np.asarray(array)
        t = self._tensor(array)
        dist.broadcast(t, src=src_rank)
        return self._back(t, array)

    def reducescatter(self, array, op: str = SUM):
        """This rank's chunk of ``np.array_split`` of the reduced, flattened
        array."""
        import torch.distributed as dist

        _reduce_op(op)
        if self.world_size == 1:
            flat = array.reshape(-1) if isinstance(array, torch.Tensor) else \
                np.asarray(array).reshape(-1)
            return flat
        flat = self._tensor(array).reshape(-1)
        n, w = flat.numel(), self.world_size
        sizes = [n // w + (1 if i < n % w else 0) for i in range(w)]
        width = max(sizes)
        wide = flat.dtype in (torch.bfloat16, torch.float16) and op == PRODUCT
        chunks = [torch.nn.functional.pad(c.float() if wide else c, (0, width - c.numel()))
                  for c in torch.split(flat, sizes)]
        out = torch.empty(width, dtype=chunks[0].dtype, device=self.device)
        dist.reduce_scatter(out, chunks, op=_reduce_op(op))
        out = out[:sizes[self.rank]]
        return self._back(out.to(flat.dtype) if wide else out, array)

    def barrier(self) -> None:
        self.allreduce(torch.zeros(1, device=self.device))

    def p2p(self, array, src_rank: int, dst_rank: int):
        """Moves src's array to dst. Every rank of the group enters it with
        the same (src, dst), bystanders with a template of the same shape
        and dtype, as the reference's paired collective. Returns the array
        on dst, None elsewhere."""
        import torch.distributed as dist

        if src_rank == dst_rank:
            raise ValueError("p2p with src_rank == dst_rank is a local copy")
        t = self._tensor(array)
        if self.rank == src_rank:
            dist.send(t, dst=dst_rank)
        elif self.rank == dst_rank:
            dist.recv(t, src=src_rank)
            return self._back(t, array)
        return None

    def send(self, array, dst_rank: int, tag: str = "") -> None:
        """p2p send; ``dst_rank`` receives it with ``recv(src_rank=<this
        rank>, like=...)``."""
        if dst_rank == self.rank:
            raise ValueError("send to self is unsupported")
        self.p2p(array, self.rank, dst_rank)

    def recv(self, src_rank: int, tag: str = "", timeout: float = 60.0, like=None):
        """p2p receive; ``like`` gives the incoming shape and dtype (the
        reference's NCCL recv takes a buffer the same way)."""
        if like is None:
            raise ValueError("recv needs like=<array of the incoming shape/dtype>")
        if src_rank == self.rank:
            raise ValueError("recv from self is unsupported")
        zeros = (torch.zeros_like(like) if isinstance(like, torch.Tensor)
                 else np.zeros_like(like))
        return self.p2p(zeros, src_rank, self.rank)

    def destroy(self) -> None:
        """Ends the process group when this group started it."""
        import torch.distributed as dist

        if self._owns_process_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_process_group = False


def init_collective_group(world_size: int, rank: int, backend: str = "nccl",
                          group_name: str = "default", config: Any = None) -> None:
    if group_name in _groups:
        raise ValueError(f"collective group {group_name!r} already initialized")
    _groups[group_name] = NcclGroup(world_size, rank, group_name, config, backend=backend)


def get_group(group_name: str = "default") -> NcclGroup:
    if group_name not in _groups:
        raise ValueError(f"collective group {group_name!r} not initialized")
    return _groups[group_name]


def destroy_collective_group(group_name: str = "default") -> None:
    group = _groups.pop(group_name, None)
    if group is not None:
        group.destroy()


def allreduce(array, group_name: str = "default", op: str = SUM):
    return get_group(group_name).allreduce(array, op=op)


def allgather(array, group_name: str = "default") -> list:
    return get_group(group_name).allgather(array)


def reducescatter(array, group_name: str = "default", op: str = SUM):
    return get_group(group_name).reducescatter(array, op=op)


def broadcast(array, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(array, src_rank=src_rank)


def barrier(group_name: str = "default") -> None:
    get_group(group_name).barrier()


def send(array, dst_rank: int, group_name: str = "default") -> None:
    get_group(group_name).send(array, dst_rank)


def recv(src_rank: int, group_name: str = "default", timeout: float = 60.0, like=None):
    return get_group(group_name).recv(src_rank, timeout=timeout, like=like)
