"""Sharded training on ``torch.distributed``: the port of the planning half
of ray_tpu's ``train/jax_utils.py`` and of its fused sharded step.

    setup = setup_sharded_training(
        lambda device: init_params(config, 0, device), make_optimizer,
        mesh=MeshSpec({"dp": 2, "fsdp": 2, "tp": 2}),
        logical_dims=param_logical_dims(config))
    step = build_sharded_train_step(lambda p, tok: loss_fn(p, tok[:, :-1], tok[:, 1:], config),
                                    setup)
    params, opt_state, loss = step(setup.params, setup.opt_state, setup.shard_batch(tokens))

One mesh expresses data, FSDP and tensor parallelism. The JAX package runs
GSPMD: one program, per-leaf ``NamedSharding``s, collectives inserted by
the compiler. Here one process runs each device. Each leaf is stored as a
``DTensor`` on a named ``DeviceMesh`` with the placements the logical-dim
rules and the FSDP policy give it (``parallel/mesh.py``). The step
gathers each leaf to what compute needs (whole over every axis but tp,
where a tp-split leaf stays split), runs the user's loss on this rank's
part of the batch inside the model's tensor-parallel context
(``parallel/tensor_parallel.py``), and DTensor's autograd reduces the
gradients back to the storage placements: summed over dp, reduce-scattered
over fsdp. The optimizer, built over the DTensor leaves, keeps its state
in the params' placements and steps each rank's shards.

Out of this slice (ROADMAP Queue A items 3a and 4): the split
fwd/bwd/grad_sync/opt step over a collective group (``group_name``), the
sharded checkpoint, the train session's mesh, and MoE on a mesh with more
than one data rank or with ep or tp above 1; each raises.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ray_tpu_torch.parallel import mesh as mesh_mod
from ray_tpu_torch.parallel import tensor_parallel as tp
from ray_tpu_torch.parallel.mesh import (
    LogicalRules, MeshSpec, NamedSharding, auto_shard_specs, mesh_axes, tree_leaves, tree_map,
)

logger = logging.getLogger(__name__)

# The axes a batch splits over; the step's loss is a mean over their ranks.
_DATA_AXES = ("dp", "fsdp")


class MemoryBudgetError(RuntimeError):
    """The planned train state cannot fit the per-device memory budget.

    Raised BEFORE any tensor is materialized (planning runs on meta
    tensors), so a config that cannot fit fails in milliseconds instead of
    running out of device memory mid-init."""


def device_memory_budget(device=None) -> int | None:
    """Per-device memory budget in bytes, or None when unknowable.

    ``RAY_TPU_HBM_BYTES`` overrides (tests and the CPU twin model a card's
    size this way); otherwise a card's total memory
    (``torch.cuda.mem_get_info``); None on the CPU, which disables the
    check: never guess a limit and refuse a runnable config."""
    env = os.environ.get("RAY_TPU_HBM_BYTES")
    if env:
        try:
            return int(float(env))
        except ValueError:
            logger.warning("ignoring unparsable RAY_TPU_HBM_BYTES=%r", env)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return None


def _leaf_nbytes(leaf: Any, sharding: NamedSharding | None = None) -> int:
    """This device's resident bytes for one (possibly sharded) leaf."""
    shape = tuple(leaf.shape)
    if isinstance(leaf, torch.Tensor):
        itemsize = leaf.element_size()
    else:
        itemsize = np.dtype(leaf.dtype).itemsize
    if sharding is not None and shape:
        shape = sharding.shard_shape(shape)
    return int(np.prod(shape, dtype=np.int64)) * itemsize


def state_bytes_per_device(tree: Any, shardings: Any = None) -> int:
    """Per-device bytes of a tree of tensors (meta ones included) or arrays
    under ``shardings`` (None: every leaf whole)."""
    leaves = [leaf for _, leaf in tree_leaves(tree)]
    shards = ([s for _, s in tree_leaves(shardings)] if shardings is not None
              else [None] * len(leaves))
    return sum(_leaf_nbytes(leaf, s) for leaf, s in zip(leaves, shards))


def ensure_train_state_fits(
    params: Any,
    shardings: Any = None,
    *,
    optimizer_slots: int = 2,
    workspace_frac: float = 0.2,
    budget: float | None = None,
    what: str = "train state",
) -> int:
    """Refuses a train state whose residency exceeds the device budget.

    Residency: params, grads and ``optimizer_slots`` optimizer moments, all
    in the params' shardings, plus ``workspace_frac`` for activations and
    workspace: (2 + slots) x 1.2 x the sharded params' bytes. Returns the
    estimate; raises MemoryBudgetError when over budget."""
    budget = device_memory_budget() if budget is None else budget
    per_state = state_bytes_per_device(params, shardings)
    estimate = int(per_state * (2 + optimizer_slots) * (1.0 + workspace_frac))
    if budget is not None and estimate > budget:
        raise MemoryBudgetError(
            f"{what} needs ~{estimate / 1e9:.1f} GB/device "
            f"(params+grads+{optimizer_slots} optimizer slots "
            f"+{workspace_frac:.0%} workspace) but the per-device budget "
            f"is {budget / 1e9:.1f} GB. Shard it: give the mesh fsdp/tp axes "
            f"instead of the replicated data-parallel path."
        )
    return estimate


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def build_mesh(axes: dict[str, int] | None = None, device=None):
    """A DeviceMesh over the initialized world; ``axes`` empty or None: a
    1-D "dp" mesh over every rank. (The JAX package's ``topology=`` for
    multi-slice meshes waits for ROADMAP Queue A item 5.)"""
    return MeshSpec(dict(axes) if axes else {"dp": _world_size()}).build(device)


def _device_of(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _place(full: torch.Tensor, sharding: NamedSharding):
    """This rank's shard of ``full`` as a DTensor in ``sharding``'s
    placements: cut locally (every rank holds the same ``full``), no
    communication; a cut shard is copied off ``full``'s storage."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    placements = sharding.placements()
    coords = mesh.get_coordinate()
    local = full
    for i, placement in enumerate(placements):
        if placement.is_shard():
            per = local.shape[placement.dim] // mesh.size(i)
            local = local.narrow(placement.dim, coords[i] * per, per)
    if local is not full:
        local = local.clone()
    return DTensor.from_local(local.detach(), mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def shard_params(params: Any, mesh, logical_dims: Any = None, *, enforce_budget: bool = True):
    """Places a tree of whole tensors (the same on every rank) onto the
    mesh as DTensors. With logical_dims the leaves take the rules'
    placements; without, they are replicated: the degenerate pure data-
    parallel case, which refuses a train state that exceeds the budget."""
    if logical_dims is not None:
        shardings = LogicalRules().tree_shardings(logical_dims, mesh)
        what = "sharded train state"
    else:
        shardings = tree_map(lambda leaf: NamedSharding(mesh, ()), params)
        what = "replicated train state"
    if enforce_budget:
        ensure_train_state_fits(params, shardings, what=what)
    if isinstance(mesh, MeshSpec):
        raise TypeError("shard_params places tensors: give it a DeviceMesh (MeshSpec.build())")
    return tree_map(_place, params, shardings)


def shard_batch(batch: Any, mesh, axis: str = "dp") -> Any:
    """A host batch as DTensors with the leading dim split over ``axis``."""
    return mesh_mod.shard_batch(batch, mesh, LogicalRules().with_overrides(batch=axis))


def iter_global_batches(it: Iterable, *, world_rank: int, world_size: int) -> Iterator:
    """Strides an iterable of batches across ranks."""
    for i, batch in enumerate(it):
        if i % world_size == world_rank:
            yield batch


def mesh_factorization(mesh) -> dict[str, int]:
    """The (dp, fsdp, tp, pp) factorization a mesh expresses."""
    axes = mesh_axes(mesh)
    return {a: int(axes.get(a, 1)) for a in ("dp", "fsdp", "tp", "pp")}


@dataclasses.dataclass
class ShardedTrainSetup:
    """What ``build_sharded_train_step`` needs, planned and materialized by
    ``setup_sharded_training``. ``opt_state`` is the torch optimizer over
    the DTensor leaves; ``opt_shardings`` are the params' own, which its
    moments take."""

    mesh: Any
    params: Any
    opt_state: Any
    param_shardings: Any
    opt_shardings: Any
    factorization: dict[str, int]
    state_bytes_per_device: int

    def shard_batch(self, batch: Any) -> Any:
        """A host batch as DTensors split over the data axes (dp x fsdp,
        dp-major) of this setup's mesh."""
        return mesh_mod.shard_batch(batch, self.mesh)


def plan_sharded_training(
    init_fn: Callable[[Any], Any],
    *,
    mesh,
    logical_dims: Any = None,
    rules: Any = None,
    fsdp_axis: str = "fsdp",
    enforce_budget: bool = True,
) -> tuple[Any, Any, int]:
    """The planning half of ``setup_sharded_training``: ``init_fn`` on the
    meta device (shapes and dtypes, no memory), per-leaf shardings on
    ``mesh`` (a MeshSpec or a DeviceMesh), and the budget check on the plan
    (``enforce_budget=False``: an infinite budget). Returns (shapes,
    shardings, estimated bytes per device)."""
    shapes = init_fn("meta")
    shardings = auto_shard_specs(shapes, mesh, logical_dims=logical_dims, rules=rules,
                                 fsdp_axis=fsdp_axis)
    estimate = ensure_train_state_fits(shapes, shardings, what="sharded train state",
                                       budget=None if enforce_budget else float("inf"))
    return shapes, shardings, estimate


def _check_tp_rules(rules: LogicalRules, mesh) -> None:
    """The model's tensor-parallel blocks split what ``DEFAULT_RULES``
    split over tp (heads, mlp, vocab; kv whole); raises for rules that
    split otherwise on a mesh with tp above 1."""
    default = LogicalRules()
    for dim in ("heads", "mlp", "vocab", "kv"):
        if rules.spec([dim], mesh) != default.spec([dim], mesh):
            raise NotImplementedError(
                f"rules map {dim!r} to {rules.spec([dim], mesh)[0]!r}: the model's "
                "tensor-parallel blocks follow DEFAULT_RULES' split over tp "
                "(ROADMAP Queue A item 3a)"
            )


def setup_sharded_training(
    init_fn: Callable[[Any], Any],
    optimizer: Callable[[Any], torch.optim.Optimizer],
    *,
    mesh=None,
    logical_dims: Any = None,
    rules: Any = None,
    fsdp_axis: str = "fsdp",
    enforce_budget: bool = True,
) -> ShardedTrainSetup:
    """Plans and materializes a sharded train state from ONE mesh.

    ``init_fn(device)`` returns the param tree on ``device`` (torch has no
    ``eval_shape``, so the plan calls it on "meta"). ``optimizer(params)``
    builds the optimizer over the tree's leaves, as ``train.step.
    make_optimizer`` does. ``mesh``: a DeviceMesh, a MeshSpec (built here,
    on the card) or None (every rank on "dp", on the card). The flow is
    plan before materialize:

      1. ``init_fn("meta")``: shapes only;
      2. per-leaf shardings from ``auto_shard_specs``;
      3. the budget check on the plan: a config that cannot fit is refused
         before any tensor is made;
      4. ``init_fn`` on the rank's device, then each leaf cut to this
         rank's shard. ``init_fn`` makes the whole tree at once, so each
         rank holds the model whole once while it cuts (JAX's
         ``jit(out_shardings=...)`` never does; ROADMAP Queue A item 3a);
      5. the optimizer over the DTensor leaves: its state takes their
         placements.
    """
    if mesh is None:
        mesh = build_mesh()
    _, shardings, estimate = plan_sharded_training(
        init_fn, mesh=mesh, logical_dims=logical_dims, rules=rules, fsdp_axis=fsdp_axis,
        enforce_budget=enforce_budget)
    if mesh_axes(mesh).get("tp", 1) > 1 and rules is not None:
        _check_tp_rules(rules, mesh)
    if isinstance(mesh, MeshSpec):
        mesh = mesh.build()
    shardings = tree_map(lambda s: NamedSharding(mesh, s.spec), shardings)
    params = tree_map(_place, init_fn(_device_of(mesh)), shardings)
    return ShardedTrainSetup(
        mesh=mesh,
        params=params,
        opt_state=optimizer(params),
        param_shardings=shardings,
        opt_shardings=shardings,
        factorization=mesh_factorization(mesh),
        state_bytes_per_device=estimate,
    )


def _compute_placements(leaf, names: tuple[str, ...]) -> tuple[tuple, tuple]:
    """(placements compute needs, placements of the local gradient) of a
    stored leaf: whole over every axis but tp, where a tp-split leaf stays
    split; the local gradient is a partial sum over the data axes (each
    rank saw its part of the batch), the shard's own over tp for a split
    leaf, and whole elsewhere (the tensor-parallel blocks give every tp
    rank the whole gradient of an unsplit leaf)."""
    from torch.distributed.tensor import Partial, Replicate

    compute, grad = [], []
    for axis, placement in zip(names, leaf.placements):
        keep = axis == "tp" and placement.is_shard()
        compute.append(placement if keep else Replicate())
        grad.append(Partial() if axis in _DATA_AXES else (placement if keep else Replicate()))
    return tuple(compute), tuple(grad)


def build_sharded_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    setup: ShardedTrainSetup,
    *,
    group_name: str | None = None,
) -> Callable[[Any, Any, Any], tuple[Any, Any, torch.Tensor]]:
    """The fused sharded step for ``loss_fn(params, batch) -> scalar``.

    Returns ``step(params, opt_state, batch) -> (params, opt_state, loss)``
    that updates params and optimizer state IN PLACE (the counterpart of
    the JAX step's donation) and returns the global mean loss, unscaled.
    ``batch`` is a tree of DTensors from ``setup.shard_batch``, or of whole
    host tensors (the same on every rank), which the step splits over the
    data axes; its leading dim must divide by the data ranks. ``loss_fn``
    sees this rank's part of the batch and the params gathered for
    compute, and must be a mean over equal-weight examples: the local loss
    is scaled by 1 / (dp x fsdp) before the backward, so that the gradients
    summed over the data ranks are those of the global mean. JAX's
    ``optimizer`` argument is not taken: ``setup.opt_state`` is the torch
    optimizer and carries its own update.

    ``group_name`` (the split step across a collective group) raises: it
    needs the port's collective group (ROADMAP Queue A item 4).
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if group_name is not None:
        raise NotImplementedError(
            "the split fwd/bwd/grad_sync/opt step over a collective group needs the port's "
            "collective group (ROADMAP Queue A item 4)"
        )
    mesh = setup.mesh
    axes = mesh_axes(mesh)
    names = tuple(axes)
    data_axes = [a for a in _DATA_AXES if a in axes]
    data_ranks = int(np.prod([axes[a] for a in data_axes], dtype=np.int64))
    ctx = tp.TPContext(
        group=mesh.get_group("tp") if "tp" in axes else None,
        rank=mesh.get_local_rank("tp") if "tp" in axes else 0,
        size=axes.get("tp", 1),
        data_ranks=data_ranks,
        ep=axes.get("ep", 1),
    )
    def gather(leaf):
        compute, grad = _compute_placements(leaf, names)
        for axis in data_axes:  # the gather, or the gradient's reduction, over axis
            tp.calls[axis] += 1
        return leaf.redistribute(mesh, compute).to_local(grad_placements=grad)

    def local_batch(x):
        if not isinstance(x, DTensor):
            x = mesh_mod.shard_batch(x, mesh)
        return x.to_local()

    def step(params, opt_state, batch):
        local = tree_map(gather, params)
        with tp.tensor_parallel(ctx):
            loss = loss_fn(local, tree_map(local_batch, batch))
        (loss / data_ranks).backward()
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        mean = loss.detach().clone()
        for axis in data_axes:
            dist.all_reduce(mean, group=mesh.get_group(axis))
            tp.calls[axis] += 1
        return params, opt_state, mean / data_ranks

    return step
