"""Device mesh and logical sharding vocabulary, on ``torch.distributed``.

Port of ray_tpu's ``parallel/mesh.py``. Every parallelism strategy is a
named axis of ONE mesh:

    dp    data parallel (batch split; gradients summed over dp)
    fsdp  fully-sharded data parallel (params, gradients and optimizer
          state sharded; each step gathers them)
    tp    tensor parallel (heads, mlp and vocab split; partial products
          all-reduced over tp)
    sp    sequence parallel
    pp    pipeline parallel
    ep    expert parallel

Model code names the dims of each leaf with *logical* names ("embed",
"heads", ...); ``LogicalRules`` maps them to mesh axes. The policy
(``LogicalRules.spec``, ``fsdp_extend_spec``, ``auto_shard_specs``) is pure:
it takes a ``MeshSpec``, a ``DeviceMesh`` or anything else with axis names
and sizes, and returns a spec, one entry per dim: ``None``, an axis name,
or a tuple of axis names, as JAX's ``PartitionSpec`` holds them. A
``NamedSharding`` pairs a mesh with a spec; on a ``DeviceMesh`` it gives
the ``DTensor`` placements. The JAX package lets GSPMD place every leaf;
here one process runs each device, and each leaf is a ``DTensor`` whose
local tensor is that rank's shard.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Any, Sequence

import torch

from ray_tpu_torch import resolve_device

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")

# Default logical-dim -> mesh-axis rules (overridable per model and run).
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp")),   # batch splits over both data axes, dp-major
    ("seq", "sp"),               # sequence/context parallelism
    ("embed", "fsdp"),           # param sharding for ZeRO-style FSDP
    ("mlp", "tp"),               # feed-forward hidden dim over tensor axis
    ("heads", "tp"),             # attention heads over tensor axis
    ("kv", None),                # k and v projections stay replicated
    ("vocab", "tp"),
    ("expert", "ep"),
    ("stage", "pp"),
)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: axis name -> size, ordered by AXES."""

    axes: dict[str, int]

    def __post_init__(self):
        for name in self.axes:
            if name not in AXES:
                raise ValueError(f"unknown mesh axis {name!r}; valid: {AXES}")
        if any(v <= 0 for v in self.axes.values()):
            raise ValueError("axis sizes must be positive")

    @property
    def size(self) -> int:
        return math.prod(self.axes.values()) if self.axes else 1

    def axis_names(self) -> tuple[str, ...]:
        """All declared axes (size-1 included: a spec may name any declared
        axis; dropping trivial axes would break those consumers)."""
        return tuple(a for a in AXES if a in self.axes) or ("dp",)

    def build(self, device=None):
        """A ``DeviceMesh`` over the initialized world, one dim per declared
        axis in AXES order. With no process group up and a mesh of size 1,
        initializes a one-rank group first: NCCL on a card, gloo on the CPU,
        rendezvous through a ``FileStore`` in a temporary directory. Runs on
        the card unless ``device`` says otherwise."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        device = resolve_device(device)
        if not dist.is_initialized():
            if self.size != 1:
                raise RuntimeError(
                    f"a mesh of {self.size} devices needs an initialized process group of "
                    f"{self.size} ranks (torch.distributed.init_process_group)"
                )
            _init_single_rank(device)
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh needs {self.size} ranks, the process group has {world}")
        if device.type == "cuda":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        names = self.axis_names()
        shape = tuple(self.axes.get(a, 1) for a in names)
        return init_device_mesh(device.type, shape, mesh_dim_names=names)


def _init_single_rank(device: torch.device) -> None:
    """A one-rank process group: NCCL on a card, gloo on the CPU."""
    import torch.distributed as dist

    path = os.path.join(tempfile.mkdtemp(prefix="ray_tpu_torch_mesh_"), "store")
    store = dist.FileStore(path, 1)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def mesh_axes(mesh: Any) -> dict[str, int]:
    """Axis name -> size of a ``MeshSpec``, a ``DeviceMesh``, or anything
    with ``axis_names`` and a ``shape`` by name, in the mesh's order."""
    if isinstance(mesh, MeshSpec):
        return {a: mesh.axes.get(a, 1) for a in mesh.axis_names()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _entry_axes(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which mesh axes split each dim of a leaf."""

    mesh: Any
    spec: tuple

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """Each rank's shard of a leaf of ``shape``. Raises when a dim does
        not divide by its axes: GSPMD would pad it, the port refuses it
        (ROADMAP Queue C)."""
        sizes = mesh_axes(self.mesh)
        out = []
        for d, size in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            parts = math.prod(sizes[a] for a in _entry_axes(entry))
            if size % parts:
                raise ValueError(
                    f"spec {self.spec} splits dim {d} of shape {tuple(shape)} into {parts} "
                    f"parts, which do not divide {size}: the port does not pad uneven "
                    f"shards (ROADMAP Queue C)"
                )
            out.append(size // parts)
        return tuple(out)

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(d)`` where the spec
        puts that axis on dim d (two axes on one dim split it major-first,
        as JAX does), else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        on_dim = {a: d for d, entry in enumerate(self.spec) for a in _entry_axes(entry)}
        return tuple(Shard(on_dim[a]) if a in on_dim else Replicate()
                     for a in mesh_axes(self.mesh))


class LogicalRules:
    """Maps logical dim names to mesh axes and builds shardings."""

    def __init__(self, rules: Sequence[tuple[str, Any]] = DEFAULT_RULES):
        self._rules = dict(rules)

    def with_overrides(self, **overrides: Any) -> "LogicalRules":
        merged = dict(self._rules)
        merged.update(overrides)
        return LogicalRules(tuple(merged.items()))

    def spec(self, logical_dims: Sequence[str | None], mesh: Any) -> tuple:
        """The spec of a leaf whose dims carry these logical names. Mesh
        axes not declared in the mesh degrade to replication, so one set of
        annotations serves every mesh shape. A dim on one axis of a tuple
        rule names that axis alone, as JAX's ``PartitionSpec`` holds it."""
        names = tuple(mesh_axes(mesh))
        entries: list = []
        used: set[str] = set()
        for dim in logical_dims:
            axis = None if dim is None else self._rules.get(dim)
            if axis is None:
                entries.append(None)
            elif isinstance(axis, (tuple, list)):
                present = tuple(a for a in axis if a in names and a not in used)
                used.update(present)
                entries.append(present[0] if len(present) == 1 else (present or None))
            elif axis in names and axis not in used:
                used.add(axis)
                entries.append(axis)
            else:
                entries.append(None)
        return tuple(entries)

    def sharding(self, logical_dims: Sequence[str | None], mesh: Any) -> NamedSharding:
        return NamedSharding(mesh, self.spec(logical_dims, mesh))

    def tree_shardings(self, logical_tree: Any, mesh: Any) -> Any:
        """A tree of logical-dim tuples -> a tree of NamedShardings."""
        return _map_logical(lambda dims: self.sharding(dims, mesh), logical_tree)


@dataclasses.dataclass(frozen=True)
class LogicalSpec:
    """Explicit per-leaf logical-dim annotation: ``LogicalSpec("embed",
    "mlp")`` names the logical dims of a 2-D leaf."""

    dims: tuple

    def __init__(self, *dims: str | None):
        object.__setattr__(self, "dims", tuple(dims))

    def __iter__(self):
        return iter(self.dims)

    def __len__(self) -> int:
        return len(self.dims)


def _is_logical_leaf(x: Any) -> bool:
    if isinstance(x, LogicalSpec):
        return True
    return isinstance(x, (tuple, list)) and all(isinstance(d, (str, type(None))) for d in x)


def _map_logical(fn, tree: Any) -> Any:
    if _is_logical_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_logical(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any, path: tuple = ()):
    """(path, leaf) of every leaf of a dict tree (a bare tensor or array is
    a tree of one leaf), in the dicts' order."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from tree_leaves(value, path + (key,))
    else:
        yield path, tree


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def fsdp_extend_spec(shape: Sequence[int], base: Sequence, mesh: Any, axis: str = "fsdp") -> tuple:
    """The FSDP auto-policy: shard the LARGEST still-unsharded dim of
    ``shape`` over ``axis``, starting from ``base``:

      * ``axis`` absent from the mesh (or size 1): no change;
      * ``axis`` already used by ``base``: no change;
      * scalars and 1-D leaves stay replicated;
      * only dims that divide evenly by the axis size are candidates;
      * among candidates the largest dim wins (ties: the leading dim).
    """
    ndim = len(shape)
    entries = list(base) + [None] * (ndim - len(base))
    used = {a for e in entries for a in _entry_axes(e)}
    size = mesh_axes(mesh).get(axis, 1)
    if size <= 1 or axis in used or ndim < 2:
        return tuple(entries)
    candidates = [d for d in range(ndim)
                  if entries[d] is None and shape[d] > 1 and shape[d] % size == 0]
    if not candidates:
        return tuple(entries)
    best = max(candidates, key=lambda d: (shape[d], -d))
    entries[best] = axis
    return tuple(entries)


def transformer_tp_rules() -> LogicalRules:
    """The tensor-parallel policy of the transformer's blocks: Megatron's
    column split of wq, w_gate and w_up and row split of wo and w_down
    ("heads" and "mlp" -> tp), the embedding and head split over vocab.
    These ARE the defaults; callers start from them and override."""
    return LogicalRules(DEFAULT_RULES)


def auto_shard_specs(
    tree: Any,
    mesh: Any,
    *,
    logical_dims: Any = None,
    rules: LogicalRules | None = None,
    fsdp_axis: str = "fsdp",
) -> Any:
    """Per-leaf NamedShardings for a whole state tree, from ONE mesh:
    ``logical_dims`` (a tree of logical-dim tuples matched to ``tree`` by
    path; a leaf it does not name has none) mapped through ``rules``, then
    the FSDP shard-largest-axis policy on every leaf of two or more dims.
    Leaves may be meta tensors: plan before materializing."""
    rules = rules or LogicalRules()
    dims_by_path = {}
    if logical_dims is not None:
        def record(path, node):
            if _is_logical_leaf(node) or not isinstance(node, dict):
                dims_by_path[path] = node
            else:
                for key, value in node.items():
                    record(path + (key,), value)
        record((), logical_dims)

    def leaf_spec(path, leaf) -> NamedSharding:
        shape = tuple(leaf.shape)
        dims = dims_by_path.get(path)
        base = rules.spec(tuple(dims), mesh) if dims is not None else ()
        return NamedSharding(mesh, fsdp_extend_spec(shape, base, mesh, fsdp_axis))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf_spec(path, node)

    return walk(tree, ())


def single_host_mesh(**axes: int):
    """A DeviceMesh over this process group (a one-rank group is started
    when none is up and the mesh has size 1)."""
    return MeshSpec(axes).build()


def shard_batch(batch: Any, mesh, rules: LogicalRules | None = None) -> Any:
    """A global host batch (the same on every rank) as DTensors with the
    leading dim split over the axes of the "batch" rule (dp-major); each
    rank keeps its slice, with no communication. Raises when the leading
    dim does not divide by the data ranks."""
    from torch.distributed.tensor import DTensor

    rules = rules or LogicalRules()
    index, count = 0, 1  # this rank's part of the batch, of count parts
    for axis in _entry_axes(rules.spec(["batch"], mesh)[0]):
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        index = index * size + mesh.get_local_rank(axis)
        count *= size

    def put(x):
        x = torch.as_tensor(x)
        if x.shape[0] % count:
            raise ValueError(
                f"batch of {x.shape[0]} does not split evenly over {count} data ranks"
            )
        per = x.shape[0] // count
        local = x[index * per:(index + 1) * per].to(mesh.device_type)
        sharding = rules.sharding(["batch"] + [None] * (x.dim() - 1), mesh)
        return DTensor.from_local(local, mesh, sharding.placements(), run_check=False,
                                  shape=x.shape, stride=x.stride())

    return tree_map(put, batch)
