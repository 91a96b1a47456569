"""Sharded training on ``torch.distributed``: the port of the planning half
of ray_tpu's ``train/jax_utils.py`` and of its fused sharded step.

    setup = setup_sharded_training(
        lambda device: init_params(config, 0, device), make_optimizer,
        mesh=MeshSpec({"dp": 2, "fsdp": 2, "tp": 2}),
        logical_dims=param_logical_dims(config))
    step = build_sharded_train_step(lambda p, tok: loss_fn(p, tok[:, :-1], tok[:, 1:], config),
                                    setup)
    params, opt_state, loss = step(setup.params, setup.opt_state, setup.shard_batch(tokens))

One mesh expresses data, FSDP, tensor and expert parallelism. The JAX package runs
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

Also here: the split fwd/bwd/grad_sync/opt step across a collective
group (``build_sharded_train_step(group_name=...)``), each phase a
``step_annotation`` scope, with the gradient syncs it runs on
(``sync_gradients``, ``begin_gradient_sync``, ``sync_gradients_sharded``,
the two-tier ``sync_gradients_hierarchical``, ``grad_psum``), the sharded
state's checkpoint (``save_sharded_state``, ``restore_sharded_state``) and
the train session's mesh, a ``SliceTopology``'s when the session has one.

The MoE experts' leaves are split over ep on their expert dim (``Shard``)
and stay split for compute, as a tp-split leaf does; each ep rank runs its
own experts and the model sums their outputs over ep
(``models/transformer.py``'s ``_moe_mlp``), so an expert leaf's gradient
is its shard's own, reduced over the data axes only, and every other
leaf's is whole and equal on every ep rank.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ray_tpu_torch.parallel import mesh as mesh_mod
from ray_tpu_torch.parallel import tensor_parallel as tp
from ray_tpu_torch.parallel._wire import axis_wire
from ray_tpu_torch.parallel.mesh import (
    LogicalRules, MeshSpec, NamedSharding, auto_shard_specs, mesh_axes, tree_leaves, tree_map,
)
from ray_tpu_torch.train.step_stats import record_phase, step_annotation

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


def build_mesh(axes: dict[str, int] | None = None, device=None, topology=None):
    """A DeviceMesh over the initialized world; ``axes`` empty or None: a
    1-D "dp" mesh over every rank. With ``topology`` (a
    ``parallel.topology.SliceTopology``) the mesh composes the DCN axes
    across domains with the ICI axes within them (``axes`` unused), as the
    trainer's ``topology=`` asks."""
    if topology is not None:
        return topology.build_mesh(device)
    return MeshSpec(dict(axes) if axes else {"dp": _world_size()}).build(device)


def _session_mesh(device=None):
    """The mesh of the active train session's ``mesh_axes`` (or its slice
    topology) on the worker's device (every rank on "dp" when it names
    none), or ``build_mesh()`` outside a session."""
    from ray_tpu_torch.train import session

    if session.in_session():
        ctx = session.get_context()
        return build_mesh(dict(ctx.mesh or {}), device or ctx.device or None,
                          topology=ctx.slice_topology)
    return build_mesh(None, device)


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
    if mesh_axes(mesh).get("ep", 1) > 1:
        _check_expert_rules(rules or LogicalRules(), mesh, shapes, logical_dims)
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


def _check_expert_rules(rules: LogicalRules, mesh, shapes: Any, logical_dims: Any) -> None:
    """The MoE block splits the experts over ep and expects the ep ranks of
    a data rank to hold the same tokens, as ``DEFAULT_RULES`` have it
    ("expert" on ep, "batch" on the data axes alone); raises for rules that
    map either otherwise on a mesh with ep above 1, and for a leaf whose
    expert dim ep does not divide (the reference's planner refuses it too;
    ROADMAP Queue C item 7)."""
    default = LogicalRules()
    for dim in ("batch", "expert"):
        if rules.spec([dim], mesh) != default.spec([dim], mesh):
            raise NotImplementedError(
                f"rules map {dim!r} to {rules.spec([dim], mesh)[0]!r}: the MoE block's "
                "expert parallelism follows DEFAULT_RULES (ROADMAP Queue A item 4b)"
            )
    ep = mesh_axes(mesh)["ep"]
    for path, leaf in tree_leaves(shapes):
        dims = logical_dims
        for key in path:
            dims = dims.get(key) if isinstance(dims, dict) else None
        if dims is not None and "expert" in tuple(dims):
            experts = leaf.shape[tuple(dims).index("expert")]
            if experts % ep:
                raise NotImplementedError(
                    f"{'/'.join(path)}: ep={ep} does not divide its {experts} experts; the "
                    "port does not pad them (ROADMAP Queue A item 4b, Queue C item 7)"
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
    on the card) or None: the train session's mesh on the worker's device,
    or outside a session every rank on "dp", on the card. The flow is plan
    before materialize:

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
        mesh = _session_mesh()
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


def _data_group(mesh, data_axes: list[str]):
    """One process group over the data axes of ``mesh`` (dp and fsdp), its
    ranks in dp-major order: the axis's own group when only one is there;
    otherwise every rank creates one group per slice of the other axes (as
    ``new_group`` needs) and keeps its own."""
    import torch.distributed as dist

    if len(data_axes) == 1:
        return mesh.get_group(data_axes[0])
    names = list(mesh.mesh_dim_names)
    data_dims = [names.index(a) for a in data_axes]
    others = [i for i in range(len(names)) if i not in data_dims]
    slices = mesh.mesh.permute(others + data_dims).reshape(-1, int(np.prod(
        [mesh.size(d) for d in data_dims])))
    mine, me = None, dist.get_rank()
    for ranks in slices.tolist():
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def _compute_placements(leaf, names: tuple[str, ...]) -> tuple[tuple, tuple]:
    """(placements compute needs, placements of the local gradient) of a
    stored leaf: whole over every axis but tp and ep, where a split leaf
    stays split; the local gradient is a partial sum over the data axes
    (each rank saw its part of the batch), the shard's own over tp or ep
    for a split leaf, and whole elsewhere (the tensor- and
    expert-parallel blocks give every tp and ep rank the whole gradient of
    an unsplit leaf)."""
    from torch.distributed.tensor import Partial, Replicate

    compute, grad = [], []
    for axis, placement in zip(names, leaf.placements):
        keep = axis in ("tp", "ep") and placement.is_shard()
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
    compute. The user's loss stays opaque, as in JAX; GSPMD computes it
    over the global batch. The step takes the mean of the ranks' losses:
    each is scaled by 1 / (dp x fsdp) before the backward, so that the
    gradients summed over the data ranks are those of that mean. It equals
    the reference's loss in two cases, and in any sum of them:

      * a loss that is a mean over equal-weight examples (an unmasked
        ``loss_fn``), or a term that is the same on every rank (a
        regulariser of the params). Exact for the even local batches
        ``shard_batch`` makes;
      * the masked ``logits_loss`` (``loss_fn(..., mask=)``): it reads the
        step's context and returns this rank's ``sum(nll * mask)`` over
        the mask's count summed across the data ranks, clamped at 1, times
        the data ranks; the mean over the ranks is then the reference's
        ``jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)`` over the
        global batch, also where the masks' counts differ across ranks.

    A user's own loss that weighs the ranks' examples unevenly (a masked
    mean of its own) gets the mean of the ranks' values, which is not the
    reference's. The MoE block routes over the global token order the same
    way (``models.transformer._moe_combine``). JAX's ``optimizer`` argument is
    not taken: ``setup.opt_state`` is the torch optimizer and carries its
    own update.

    ``group_name`` names a collective group of this process's gang
    (``util.collective``): the step then runs JAX's split form across the
    group's workers (``_split_step``). The fused step is one program in the
    reference and carries no ``step_annotation`` scopes; neither does this.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    mesh = setup.mesh

    def local_batch(x):
        if not isinstance(x, DTensor):
            x = mesh_mod.shard_batch(x, mesh)
        return x.to_local()

    if group_name is not None:
        from ray_tpu_torch.util import collective

        if collective.get_group(group_name).world_size > 1:
            return _split_step(loss_fn, setup, group_name, local_batch)
    axes = mesh_axes(mesh)
    names = tuple(axes)
    data_axes = [a for a in _DATA_AXES if a in axes]
    data_ranks = int(np.prod([axes[a] for a in data_axes], dtype=np.int64))
    data_rank = 0
    for axis in data_axes:  # this rank's index in the dp-major order
        data_rank = data_rank * axes[axis] + mesh.get_local_rank(axis)
    ctx = tp.TPContext(
        group=mesh.get_group("tp") if "tp" in axes else None,
        rank=mesh.get_local_rank("tp") if "tp" in axes else 0,
        size=axes.get("tp", 1),
        data_ranks=data_ranks,
        ep=axes.get("ep", 1),
        data_group=_data_group(mesh, data_axes) if data_ranks > 1 else None,
        data_rank=data_rank,
        ep_wire=axis_wire(mesh, "ep") if axes.get("ep", 1) > 1 else None,
        ep_rank=mesh.get_local_rank("ep") if "ep" in axes else 0,
    )

    def gather(leaf):
        compute, grad = _compute_placements(leaf, names)
        for axis in data_axes:  # the gather, or the gradient's reduction, over axis
            tp.calls[axis] += 1
        return leaf.redistribute(mesh, compute).to_local(grad_placements=grad)

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


def _split_step(loss_fn, setup: ShardedTrainSetup, group_name: str,
                local_batch: Callable) -> Callable:
    """JAX's split form across a collective group (``jax_utils.py``'s
    ``build_sharded_train_step`` with ``group_name``): forward, backward,
    an eager gradient mean through the group, then the optimizer, each a
    ``step_annotation`` scope ("fwd", "bwd", "grad_sync", "opt"; the
    reference's phases: fwd, bwd and opt time the StepStats split, the
    sync's time is the collective layer's) whose seconds land in
    ``step.stats``. Each scope ends with the device synchronized, so its
    kernels finish inside it; each of those syncs closes an edge the next
    phase waits on anyway. The group's workers are the mesh's data ranks:
    the mesh must be dp over exactly them, its leaves replicated, so that
    each rank's gradient is whole before the sync.

    As in the reference, where each worker owns a private mesh, the loss
    is this worker's over its part of the batch alone (a masked mean over
    its own mask, MoE routed over its own tokens), the update takes the
    mean of the workers' gradients, and the step returns this worker's
    loss."""
    from ray_tpu_torch.util import collective

    group = collective.get_group(group_name)
    axes = mesh_axes(setup.mesh)
    if axes.get("dp", 1) != group.world_size or any(
            n > 1 for a, n in axes.items() if a != "dp"):
        raise NotImplementedError(
            f"the split step syncs whole gradients over group {group_name!r} of "
            f"{group.world_size} workers: it takes a mesh of dp {group.world_size} only "
            f"(fsdp, tp and ep split leaves across the workers), got {axes}")
    leaves = [leaf for _, leaf in tree_leaves(setup.params)]
    ctx = tp.TPContext(group=None, rank=0, size=1)  # the worker's own mesh

    def sync_device():
        if setup.mesh.device_type == "cuda":
            torch.cuda.synchronize()

    def step(params, opt_state, batch):
        t0 = time.perf_counter()
        with step_annotation("fwd", phase="fwd"):
            local = tree_map(lambda leaf: leaf.to_local(), params)
            with tp.tensor_parallel(ctx):
                loss = loss_fn(local, tree_map(local_batch, batch))
            sync_device()
        t1 = time.perf_counter()
        with step_annotation("bwd", phase="bwd"):
            loss.backward()
            sync_device()
        t2 = time.perf_counter()
        with step_annotation("grad_sync"):
            grads = [leaf.grad.to_local() for leaf in leaves]
            for grad, synced in zip(grads, sync_gradients(grads, group_name)):
                grad.copy_(synced)
            sync_device()
        t3 = time.perf_counter()
        with step_annotation("opt", phase="opt"):
            opt_state.step()
            opt_state.zero_grad(set_to_none=True)
            sync_device()
        t4 = time.perf_counter()
        step.stats = {"fwd_s": t1 - t0, "bwd_s": t2 - t1, "grad_sync_s": t3 - t2,
                      "opt_s": t4 - t3}
        return params, opt_state, loss.detach()

    step.stats = {}
    return step


# ---------------------------------------------------------------------------
# Gradient syncs across a collective group (ray_tpu/train/jax_utils.py)
# ---------------------------------------------------------------------------

# Payload of one bucket of an overlapped sync, as the reference's default.
DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024


def _flat(leaves: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([leaf.detach().float().reshape(-1) for leaf in leaves])


def _unflat(flat: torch.Tensor, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    out, offset = [], 0
    for leaf in leaves:
        n = leaf.numel()
        out.append(flat[offset:offset + n].reshape(leaf.shape).to(leaf.dtype))
        offset += n
    return out


def _tree_leaves_list(tree: Any) -> tuple[list, Callable[[list], Any]]:
    """A tree's leaves and the function that rebuilds the tree from new
    ones (a list of tensors is its own tree)."""
    if isinstance(tree, list):
        return list(tree), list
    paths = [path for path, _ in tree_leaves(tree)]
    return ([leaf for _, leaf in tree_leaves(tree)],
            lambda values: _rebuild(tree, dict(zip(paths, values))))


def _rebuild(tree: Any, found: dict, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, found, path + (k,)) for k, v in tree.items()}
    return found[path]


def sync_gradients(grads: Any, group_name: str) -> Any:
    """The mean of ``grads`` (a dict tree or a list of tensors) across the
    group's workers: one all-reduce of the leaves flattened in f32, each
    leaf cast back to its dtype. A group of one returns ``grads``."""
    from ray_tpu_torch.util import collective

    group = collective.get_group(group_name)
    if group.world_size == 1:
        return grads
    leaves, rebuild = _tree_leaves_list(grads)
    flat = group.allreduce(_flat(leaves)) / group.world_size
    return rebuild(_unflat(flat, leaves))


class GradientSyncHandle:
    """An in-flight overlapped gradient sync (``begin_gradient_sync``)."""

    def __init__(self, works, buckets, leaves, rebuild, denom, launch_s):
        self._works, self._buckets, self._leaves = works, buckets, leaves
        self._rebuild, self._denom = rebuild, denom
        self.stats: dict[str, float] = {"buckets": len(buckets), "launch_s": launch_s}

    def result(self) -> Any:
        """Fence: waits for every bucket, each wait a ``fence.b<i>`` scope on
        the trace, records the whole wait as the exposed communication time
        (the step's "comm_exposed" phase), and returns the mean gradient
        tree."""
        start = time.perf_counter()
        cuda = bool(self._buckets) and self._buckets[0][1].device.type == "cuda"
        for i, work in enumerate(self._works):
            with step_annotation(f"fence.b{i}"):
                if work is not None:
                    work.wait()
                if cuda:
                    torch.cuda.current_stream().synchronize()
        self.stats["comm_exposed_s"] = time.perf_counter() - start
        record_phase("comm_exposed", max(self.stats["comm_exposed_s"], 1e-9))
        out: list = [None] * len(self._leaves)
        for indices, flat in self._buckets:
            chunk = [self._leaves[i] for i in indices]
            for i, value in zip(indices, _unflat(flat / self._denom, chunk)):
                out[i] = value
        return self._rebuild(out)


def begin_gradient_sync(grads: Any, group_name: str, *,
                        bucket_bytes: int | None = None) -> GradientSyncHandle:
    """Launches a bucketed, asynchronous gradient mean of ``grads`` (a dict
    tree or a list of tensors) and returns at once. The port runs one
    process a device, so where the reference takes one tree per local
    device, this takes the process's one tree. Its leaves are split into
    buckets of about ``bucket_bytes`` of f32, in reverse leaf order (the
    last layers' gradients, which the backward makes first, go first),
    each an all-reduce with ``async_op=True``. ``handle.result()``
    fences."""
    import torch.distributed as dist

    from ray_tpu_torch.util import collective

    group = collective.get_group(group_name)
    start = time.perf_counter()
    leaves, rebuild = _tree_leaves_list(grads)
    limit = (bucket_bytes or DEFAULT_BUCKET_BYTES) // 4
    buckets, current, size = [], [], 0
    for i in reversed(range(len(leaves))):
        current.append(i)
        size += leaves[i].numel()
        if size >= limit:
            buckets.append(current)
            current, size = [], 0
    if current:
        buckets.append(current)
    works, flats = [], []
    for indices in buckets:
        flat = _flat([leaves[i] for i in indices]).to(group.device)
        works.append(dist.all_reduce(flat, async_op=True) if group.world_size > 1 else None)
        flats.append((indices, flat))
    return GradientSyncHandle(works, flats, leaves, rebuild, group.world_size,
                              time.perf_counter() - start)


def sync_gradients_sharded(grads: Any, group_name: str, *, overlap: bool = False,
                           bucket_bytes: int | None = None) -> Any:
    """The mean of ``grads`` over the group's workers (one tree: one process
    a device): ``sync_gradients``, or with ``overlap=True`` the bucketed
    asynchronous path, fenced before returning."""
    if overlap:
        return begin_gradient_sync(grads, group_name, bucket_bytes=bucket_bytes).result()
    return sync_gradients(grads, group_name)


def sync_gradients_hierarchical(per_device_grads: list, group_name: str) -> Any:
    """Two-tier gradient mean for a ``hier`` group: one gradient tree (a dict
    tree or a list of tensors) per local device in, the tree averaged over
    every device of every rank out (``jax_utils.sync_gradients_sharded``).
    Each tree is flattened in f32; ``allreduce_sharded`` reduces the local
    ones on their device, then across ranks; the sum is divided by world
    size x local devices and each leaf cast back to its dtype. A group
    without ``allreduce_sharded`` takes the flat way: the local sum, then
    its all-reduce."""
    from ray_tpu_torch.util import collective

    group = collective.get_group(group_name)
    leaves, rebuild = _tree_leaves_list(per_device_grads[0])
    flats = [_flat(_tree_leaves_list(grads)[0]) for grads in per_device_grads]
    denom = group.world_size * len(flats)
    if hasattr(group, "allreduce_sharded"):
        total = group.allreduce_sharded(flats)
    else:
        total = torch.stack(flats).sum(dim=0)
        if group.world_size > 1:
            total = group.allreduce(total)
    return rebuild(_unflat(total / denom, leaves))


def grad_psum(x: torch.Tensor, axis: str = "dp", *, mesh=None,
              topology=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh``'s ``axis`` (every rank of the
    process group when no mesh is given): the in-step gradient reduce. With
    ``topology`` (a ``SliceTopology``) the sum runs tier by tier over the
    mesh its ``build_mesh`` made (``mesh``, required): ICI axes first, then
    DCN."""
    import torch.distributed as dist

    if topology is not None:
        if mesh is None:
            raise ValueError("grad_psum(topology=...) needs mesh=, the mesh that "
                             "topology.build_mesh() returned")
        return topology.hierarchical_psum(x, mesh)
    out = x.detach().clone()
    if mesh is not None and axis not in mesh_axes(mesh):
        return out
    dist.all_reduce(out, group=mesh.get_group(axis) if mesh is not None else None)
    return out


# ---------------------------------------------------------------------------
# The sharded state's checkpoint (ray_tpu/train/jax_utils.py)
# ---------------------------------------------------------------------------


def save_sharded_state(params: Any, opt_state: torch.optim.Optimizer, *,
                       extra: dict | None = None):
    """Persists {"params", "opt_state"} as one checkpoint (``train.
    checkpoint``'s two-phase format): each leaf's shards with their global
    index, the optimizer's state under optax's key paths
    (``models.convert.optax_adam_state``), so that
    ``restore_sharded_state`` places the state onto any (dp, fsdp, tp)
    factorization, and the JAX package reads it. Returns the Checkpoint."""
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.train.checkpoint import save_pytree_checkpoint

    return save_pytree_checkpoint(
        {"params": params, "opt_state": convert.optax_adam_state(opt_state, params)},
        extra=extra)


def restore_sharded_state(checkpoint, setup: ShardedTrainSetup) -> tuple[Any, Any, dict]:
    """Loads a checkpoint onto ``setup``'s mesh, whatever factorization
    wrote it (dp 4 restores onto dp 2 x fsdp 2): each rank copies its
    shard of every parameter into ``setup.params`` in place (the optimizer
    holds those tensors) and sets the optimizer's step and moments,
    placed like their parameters. Returns (params, opt_state, extra)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import convert
    from ray_tpu_torch.train.checkpoint import load_pytree_checkpoint

    template = {"params": setup.params,
                "opt_state": convert.optax_adam_template(setup.opt_state, setup.params)}
    tree, extra = load_pytree_checkpoint(checkpoint, template)
    sharding_of = {id(leaf): s for (_, leaf), (_, s) in
                   zip(tree_leaves(setup.params), tree_leaves(setup.param_shardings))}
    device = _device_of(setup.mesh)

    def place(full: torch.Tensor, leaf) -> torch.Tensor:
        full = full.to(device=device, dtype=leaf.dtype)
        if isinstance(leaf, DTensor):
            return _place(full, sharding_of[id(leaf)])
        return full

    with torch.no_grad():
        for (_, leaf), (_, full) in zip(tree_leaves(setup.params), tree_leaves(tree["params"])):
            shard = place(full, leaf)
            if isinstance(leaf, DTensor):
                leaf.to_local().copy_(shard.to_local())
            else:
                leaf.copy_(shard)
    convert.load_optax_adam_state(setup.opt_state, setup.params, tree["opt_state"], place)
    return setup.params, setup.opt_state, extra
