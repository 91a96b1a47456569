"""Pipeline parallelism over the ``pp`` mesh axis: the 1F1B schedules and
``pipeline_apply``.

Port of ray_tpu's ``parallel/pipeline.py``. The schedules
(``schedule_1f1b``, ``schedule_interleaved_1f1b``, ``validate_schedule``,
``bubble_fraction``) are pure Python, copied as they are: the stage runner
(``train/stage_runner.py``) executes one rank's op stream from them.
``check_message_order`` is the port's own: torch's point-to-point calls
pair in the order they were posted, where the reference pairs them by tag
in a mailbox, so a schedule the runner executes must post each edge's
sends in the order the receiving rank posts their receives.

``pipeline_apply`` is the single-program GPipe form: each ``pp`` rank
holds its share of the stacked layers and runs ``num_micro + size - 1``
ticks; stage 0 reads fresh microbatches, later stages the activations the
rank before handed over (``_wire.shift``, the counterpart of
``ppermute``); the last stage records each finished microbatch and a sum
over the ranks gives every rank the outputs. It is differentiable: the
shift's backward is the reverse shift.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ray_tpu_torch.parallel import _wire
from ray_tpu_torch.parallel.mesh import tree_map


# ---------------------------------------------------------------------------
# Microbatch scheduling (the stage runner's op streams)
# ---------------------------------------------------------------------------
def schedule_1f1b(
    num_stages: int, num_microbatches: int, stage: int
) -> list[tuple[str, int]]:
    """This stage's op stream under the 1F1B (PipeDream-flush) schedule.

    Returns an ordered list of ``("F", m)`` / ``("B", m)`` ops. Warmup
    runs ``num_stages - stage - 1`` forwards, the steady state strictly
    alternates 1F1B, and the cooldown drains the remaining backwards —
    so at most ``num_stages - stage`` activations are ever live on a
    stage (the memory win over GPipe, at identical bubble).
    """
    if not (0 <= stage < num_stages):
        raise ValueError(f"stage {stage} out of range [0, {num_stages})")
    if num_microbatches < 1:
        raise ValueError("num_microbatches must be >= 1")
    warmup = min(num_microbatches, num_stages - stage - 1)
    ops: list[tuple[str, int]] = [("F", m) for m in range(warmup)]
    fwd, bwd = warmup, 0
    while fwd < num_microbatches:
        ops.append(("F", fwd))
        fwd += 1
        ops.append(("B", bwd))
        bwd += 1
    while bwd < num_microbatches:
        ops.append(("B", bwd))
        bwd += 1
    return ops


def schedule_interleaved_1f1b(
    num_stages: int,
    num_microbatches: int,
    stage: int,
    num_virtual: int = 1,
) -> list[tuple[str, int, int]]:
    """This RANK's op stream under interleaved 1F1B (Megatron-style
    virtual pipeline stages).

    Each physical rank hosts ``num_virtual`` model CHUNKS; chunk ``c``
    on rank ``r`` is virtual stage ``c * num_stages + r``, so the
    virtual pipeline wraps around the physical ring ``num_virtual``
    times. Microbatches flow through the ranks in groups of
    ``num_stages``: a rank runs ``num_stages`` forwards of chunk 0, then
    the SAME microbatch group through chunk 1, …, and backwards mirror
    in reverse-chunk order. Fill/drain shrinks from one chunk-sized ramp
    to one stage-sized ramp — bubble (S−1)/(M+S−1) → (S−1)/(v·M+S−1),
    see :func:`bubble_fraction`.

    Returns ``("F"|"B", microbatch, chunk)`` ops. ``num_virtual=1``
    reduces exactly to :func:`schedule_1f1b` (with chunk 0 appended).
    ``num_virtual > 1`` requires ``num_microbatches % num_stages == 0``
    (the microbatch-group rotation needs full groups).
    """
    if not (0 <= stage < num_stages):
        raise ValueError(f"stage {stage} out of range [0, {num_stages})")
    if num_microbatches < 1 or num_virtual < 1:
        raise ValueError("num_microbatches and num_virtual must be >= 1")
    if num_virtual == 1:
        return [(kind, m, 0) for kind, m in
                schedule_1f1b(num_stages, num_microbatches, stage)]
    if num_microbatches % num_stages != 0:
        raise ValueError(
            f"interleaved 1F1B needs num_microbatches divisible by "
            f"num_stages, got M={num_microbatches} S={num_stages}"
        )
    total = num_microbatches * num_virtual
    group = num_stages * num_virtual  # one full rotation of the chunks

    def fwd(i: int) -> tuple[str, int, int]:
        chunk = (i // num_stages) % num_virtual
        micro = (i // group) * num_stages + i % num_stages
        return ("F", micro, chunk)

    def bwd(i: int) -> tuple[str, int, int]:
        chunk = num_virtual - 1 - (i // num_stages) % num_virtual
        micro = (i // group) * num_stages + i % num_stages
        return ("B", micro, chunk)

    # Megatron warmup: enough forwards that the LAST virtual stage has
    # run its first microbatch before anyone turns around, plus the
    # 2-per-rank stagger that keeps the steady state collision-free.
    warmup = min(
        total, (num_stages - stage - 1) * 2 + (num_virtual - 1) * num_stages
    )
    ops = [fwd(i) for i in range(warmup)]
    for i in range(total - warmup):
        ops.append(fwd(warmup + i))
        ops.append(bwd(i))
    for i in range(total - warmup, total):
        ops.append(bwd(i))
    return ops


def _normalize_schedules(schedules):
    """Accept both (kind, m) and (kind, m, chunk) op streams."""
    out = []
    for ops in schedules:
        out.append([
            (op[0], op[1], op[2] if len(op) > 2 else 0) for op in ops
        ])
    return out


def validate_schedule(
    schedules: Sequence[Sequence[tuple]],
    num_virtual: int = 1,
) -> None:
    """Check a per-rank op-stream set for pipeline correctness.

    Simulates the ranks tick-by-tick with blocking p2p dependencies and
    raises if any rank's stream would deadlock, skip a microbatch, or
    run B before its own F. Ops may be ``(kind, m)`` (plain 1F1B) or
    ``(kind, m, chunk)`` (interleaved; pass ``num_virtual``). In virtual
    stage terms (vs = chunk·S + rank): F(m) at vs needs F(m) done at
    vs−1, B(m) at vs needs B(m) done at vs+1 — the wraparound hops
    between chunks ride the same physical neighbor links.

    The 1F1B live-activation bound (≤ num_stages − rank) is enforced
    only for ``num_virtual == 1``: interleaving trades that bound for
    the smaller bubble (live activations grow with v by design).
    """
    num_stages = len(schedules)
    schedules = _normalize_schedules(schedules)
    num_vs = num_stages * num_virtual
    done_f: dict[int, set] = {vs: set() for vs in range(num_vs)}
    done_b: dict[int, set] = {vs: set() for vs in range(num_vs)}
    cursors = [0] * num_stages
    progressed = True
    while progressed:
        progressed = False
        for s, ops in enumerate(schedules):
            while cursors[s] < len(ops):
                kind, m, chunk = ops[cursors[s]]
                if not (0 <= chunk < num_virtual):
                    raise ValueError(
                        f"rank {s}: chunk {chunk} out of range "
                        f"[0, {num_virtual})"
                    )
                vs = chunk * num_stages + s
                if kind == "F":
                    if vs > 0 and m not in done_f[vs - 1]:
                        break
                    done_f[vs].add(m)
                elif kind == "B":
                    if m not in done_f[vs]:
                        raise ValueError(
                            f"rank {s}: B({m}) chunk {chunk} before its "
                            f"own F({m})"
                        )
                    if vs < num_vs - 1 and m not in done_b[vs + 1]:
                        break
                    done_b[vs].add(m)
                else:
                    raise ValueError(f"rank {s}: unknown op {kind!r}")
                if num_virtual == 1:
                    live = len(done_f[vs]) - len(done_b[vs])
                    if live > num_stages - s:
                        raise ValueError(
                            f"stage {s}: {live} live activations exceeds "
                            f"the 1F1B bound {num_stages - s}"
                        )
                cursors[s] += 1
                progressed = True
    stuck = [s for s in range(num_stages) if cursors[s] < len(schedules[s])]
    if stuck:
        raise ValueError(f"schedule deadlocks at stages {stuck}")
    for s in range(num_stages):
        for chunk in range(num_virtual):
            vs = chunk * num_stages + s
            micro = {m for kind, m, c in schedules[s] if c == chunk}
            if done_f[vs] != micro or done_b[vs] != micro:
                raise ValueError(
                    f"rank {s} chunk {chunk}: incomplete F/B coverage"
                )


def edge_messages(
    schedules: Sequence[Sequence[tuple]], num_virtual: int = 1
) -> tuple[dict, dict]:
    """The messages a stage runner posts for these op streams, in each
    rank's program order: (sends, recvs), each mapping a directed edge
    (src rank, dst rank) to the list of tags crossing it, named as the
    reference names them (``f{m}v{vs}``: the activation virtual stage vs
    takes for microbatch m; ``b{m}v{vs}``: the cotangent vs takes)."""
    num_stages = len(schedules)
    last_vs = num_stages * num_virtual - 1
    sends: dict[tuple[int, int], list[str]] = {}
    recvs: dict[tuple[int, int], list[str]] = {}
    for s, ops in enumerate(_normalize_schedules(schedules)):
        prev, nxt = (s - 1) % num_stages, (s + 1) % num_stages
        for kind, m, chunk in ops:
            vs = chunk * num_stages + s
            if kind == "F":
                if vs > 0:
                    recvs.setdefault((prev, s), []).append(f"f{m}v{vs}")
                if vs < last_vs:
                    sends.setdefault((s, nxt), []).append(f"f{m}v{vs + 1}")
            else:
                if vs < last_vs:
                    recvs.setdefault((nxt, s), []).append(f"b{m}v{vs}")
                if vs > 0:
                    sends.setdefault((s, prev), []).append(f"b{m}v{vs - 1}")
    return sends, recvs


def check_message_order(
    schedules: Sequence[Sequence[tuple]], num_virtual: int = 1
) -> None:
    """Raises unless, on every directed edge, the sending rank posts its
    messages in the order the receiving rank posts its receives: the
    condition under which point-to-point calls that pair in posting order
    (torch's, NCCL's) deliver every message to the receive meant for it."""
    sends, recvs = edge_messages(schedules, num_virtual)
    for edge in sorted(set(sends) | set(recvs)):
        sent, taken = sends.get(edge, []), recvs.get(edge, [])
        if sent != taken:
            at = next((i for i, (a, b) in enumerate(zip(sent, taken)) if a != b),
                      min(len(sent), len(taken)))
            raise ValueError(
                f"edge {edge[0]}->{edge[1]}: message {at} is sent as "
                f"{sent[at] if at < len(sent) else None} but received as "
                f"{taken[at] if at < len(taken) else None}; a wire that pairs "
                f"messages in posting order would swap them"
            )


def bubble_fraction(
    num_stages: int, num_microbatches: int, num_virtual: int = 1
) -> float:
    """The ideal pipeline-bubble fraction: the share of each stage's
    wall clock spent idle during fill+drain when every microbatch tick
    costs the same. Plain 1F1B and GPipe share (P−1)/(M+P−1) — 1F1B
    only improves the activation-memory bound. Interleaving the model
    into ``num_virtual`` chunks per rank divides the ramp's share of
    useful work: (P−1)/(v·M+P−1). The stage runner's ``pp_bubble``
    phase is the measured counterpart."""
    if num_stages < 1 or num_microbatches < 1 or num_virtual < 1:
        raise ValueError(
            "num_stages, num_microbatches, num_virtual must be >= 1"
        )
    return (num_stages - 1) / (
        num_virtual * num_microbatches + num_stages - 1
    )


# ---------------------------------------------------------------------------
# The single-program pipeline
# ---------------------------------------------------------------------------
def _local_shard(leaf: torch.Tensor, spec, axis_name: str, rank: int, size: int) -> torch.Tensor:
    """This rank's block of ``leaf`` along the dim ``spec`` assigns to
    ``axis_name`` (the whole leaf when it assigns none)."""
    spec = tuple(spec) if spec is not None else ()
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        if axis_name in names:
            if leaf.shape[dim] % size:
                raise ValueError(
                    f"dim {dim} of size {leaf.shape[dim]} does not split over {size} "
                    f"{axis_name} ranks")
            return leaf.chunk(size, dim=dim)[rank]
    return leaf


def _pipeline_local(stage_fn, stage_params, x_micro, *, wire, num_micro):
    """One rank's ticks. stage_params: this rank's layer shard. x_micro:
    [num_micro, micro_batch, ...] (the same on every rank). Returns the
    [num_micro, micro_batch, ...] outputs, the same on every rank.

    Every rank runs ``stage_fn`` and the shift on every tick and keeps
    each result in the graph, masked where the reference masks it, so
    that every rank's backward runs the same shifts in the same order."""
    size, rank = wire.size, wire.rank
    is_first = torch.tensor(rank == 0, device=x_micro.device)
    buffer = torch.zeros_like(x_micro[0])
    outputs = [torch.zeros_like(x_micro[0]) for _ in range(num_micro)]
    for t in range(num_micro + size - 1):
        micro_index = t - rank
        active = 0 <= micro_index < num_micro
        safe_index = min(max(micro_index, 0), num_micro - 1)
        # Stage 0 reads fresh input; later stages read the hand-off buffer.
        x_in = torch.where(is_first, x_micro[safe_index], buffer)
        y = stage_fn(stage_params, x_in)
        y = torch.where(torch.tensor(active, device=y.device), y, torch.zeros_like(y))
        # Last stage records its finished microbatch.
        record = torch.tensor(active and rank == size - 1, device=y.device)
        outputs[safe_index] = torch.where(record, y, outputs[safe_index])
        # Hand activations to the next stage.
        buffer = _wire.shift(y, wire)
    # The last stage's outputs reach every rank.
    return _wire.all_reduce_replicated(torch.stack(outputs), wire)


def pipeline_apply(
    stage_fn: Callable,
    stacked_params: Any,
    x: torch.Tensor,
    *,
    mesh: Any,
    num_microbatches: int,
    axis_name: str = "pp",
    param_specs: Any = None,
) -> torch.Tensor:
    """Apply a layer-stacked function as a pipeline.

    stage_fn(stage_params, x) must apply ONE rank's layer shard (e.g. a
    loop over the local layers). stacked_params: a dict tree (or one
    tensor) whose leaves lead
    with the full layer dim, the same on every rank of ``axis_name``; each
    rank takes its block of it (``param_specs``: a tree of specs, one
    entry per dim, an entry naming ``axis_name`` marks the split dim; by
    default every leaf's dim 0). x: [batch, ...] with batch divisible by
    num_microbatches, the same on every rank. Returns [batch, ...] on every
    rank.

    Differentiable in the params and x. The output's gradient is taken as
    every rank's whole cotangent (the ranks compute what follows it alike,
    as the reference's replicated output implies); each rank's parameter
    gradient lands on its block, and x's on the first rank.
    """
    batch = x.shape[0]
    if batch % num_microbatches != 0:
        raise ValueError(f"batch {batch} not divisible by num_microbatches={num_microbatches}")
    micro = batch // num_microbatches
    x_micro = x.reshape(num_microbatches, micro, *x.shape[1:])
    wire = _wire.axis_wire(mesh, axis_name)
    if param_specs is None:
        param_specs = tree_map(lambda leaf: (axis_name,), stacked_params)
    local = tree_map(
        lambda leaf, spec: _local_shard(leaf, spec, axis_name, wire.rank, wire.size),
        stacked_params, param_specs)
    out = _pipeline_local(stage_fn, local, x_micro, wire=wire, num_micro=num_microbatches)
    return out.reshape(batch, *out.shape[2:])


def pipeline_step(
    stage_fn: Callable,
    stacked_params: Any,
    x: torch.Tensor,
    *,
    mesh: Any,
    num_microbatches: int,
    axis_name: str = "pp",
    param_specs: Any = None,
) -> torch.Tensor:
    """Public entry point: run one pipelined application of ``stage_fn``.

    Single-program form of the pipeline — the ranks hand activations over
    the ``pp`` axis. The multi-program form lives in
    ``train.stage_runner``, driven by :func:`schedule_interleaved_1f1b`.
    """
    return pipeline_apply(
        stage_fn,
        stacked_params,
        x,
        mesh=mesh,
        num_microbatches=num_microbatches,
        axis_name=axis_name,
        param_specs=param_specs,
    )
