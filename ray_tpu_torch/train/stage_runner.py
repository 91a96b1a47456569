"""The pipeline-stage runner: (interleaved) 1F1B across the workers of a
``TorchTrainer`` gang.

Port of ray_tpu's ``train/_internal/stage_runner.py``. Each pipeline rank
is a separate program on its own gang worker, holding one or more
contiguous chunks of the model's layers. Workers run an ordinary train
loop and ``report()`` per step; inside the step this runner executes the
rank's op stream from ``parallel.pipeline.schedule_interleaved_1f1b``,
handing activations (forward) and their cotangents (backward) to the
neighbour ranks over the wire (``parallel._wire``).

With ``virtual > 1`` chunks per rank, chunk ``c`` on rank ``r`` is virtual
stage ``c * num_stages + r``: the virtual pipeline wraps the physical ring
``virtual`` times, shrinking the fill/drain bubble from (S-1)/(M+S-1) to
(S-1)/(v*M+S-1), and every virtual edge vs -> vs+1 is the same physical
next-neighbour hop.

Memory follows the 1F1B bound on stashed inputs: the backward recomputes
the chunk forward from the saved input under autograd (full per-chunk
remat) instead of holding its activations. The last virtual stage takes
loss and gradient together; the first takes the microbatch's int tokens
and sends no cotangent. Gradients are summed over the microbatches,
divided by their count, and each chunk's optimizer steps once a step.

The wire is exact: the reference's int8/fp8 activation codec belongs to
its host-memory ``ring``/``hier`` backends, which the port does not have.
torch's point-to-point calls pair in posting order where the reference's
mailbox pairs them by tag, so the runner refuses a schedule whose sends on
some edge come in another order than their receives
(``pipeline.check_message_order``); every schedule
``schedule_interleaved_1f1b`` makes passes it.

``stats`` holds the last step's seconds by phase: ``fwd``, ``bwd``,
``opt`` and ``pp_bubble``, the time blocked in ``recv`` (the rank's stream
synchronized after each compute, so the wait is not the stage's own
work), and ``step``, the whole step. As in the reference's runner, fwd,
bwd and opt are also ``step_annotation`` scopes (a device trace names
them, the StepStats record splits compute by them) and the recv wait is
the StepStats "pp_bubble" phase.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ray_tpu_torch.parallel import _wire
from ray_tpu_torch.parallel.mesh import tree_leaves, tree_map
from ray_tpu_torch.train.step_stats import record_phase, step_annotation
from ray_tpu_torch.parallel.pipeline import (
    check_message_order, schedule_interleaved_1f1b, validate_schedule,
)


class PipelineStageRunner:
    """Runs ONE rank's part of the (interleaved) 1F1B schedule.

    Parameters
    ----------
    ctx : the train session's ``TrainContext`` (its ``pipeline`` says which
        stage this rank is).
    stage_fn : (chunk_params, activations) -> activations, or a sequence
        of ``virtual`` such callables (one per local chunk). The FIRST
        virtual stage receives the microbatch's model inputs instead of
        activations.
    last_stage_fn : (chunk_params, activations, microbatch) -> scalar loss
        for the LAST virtual stage (last rank's last chunk).
    params : dict tree, or a sequence of ``virtual`` trees: this rank's
        chunk parameters, on the rank's device. Updated in place.
    optimizer : (chunk_params) -> torch.optim.Optimizer over its leaves,
        called once per chunk (``torch.optim.SGD(leaves, lr=0.1)`` is the
        counterpart of ``optax.sgd(0.1)``).
    activation_like : (microbatch) -> an object with the ``shape`` and
        ``dtype`` of one microbatch's activations (a meta tensor will do):
        what ``recv`` allocates.
    microbatch_fn : (batch, index, count) -> microbatch.
    wire : the ranks' wire; by default a ``ProcessGroupWire`` over the
        process group, with a group per directed neighbour edge.
    """

    def __init__(
        self,
        *,
        ctx: Any,
        stage_fn: Callable | Sequence[Callable],
        last_stage_fn: Callable,
        params: Any,
        optimizer: Callable[[Any], torch.optim.Optimizer],
        activation_like: Callable,
        microbatch_fn: Callable,
        wire: _wire.Wire | None = None,
    ):
        pipe = ctx.pipeline
        if not pipe:
            raise ValueError(
                "PipelineStageRunner needs ScalingConfig.pipeline_stages > 1 "
                "(TrainContext.pipeline is unset)")
        self.stage = int(pipe["stage"])
        self.num_stages = int(pipe["num_stages"])
        self.microbatches = int(pipe["microbatches"])
        self.virtual = int(pipe.get("virtual", 1))
        if ctx.world_size != self.num_stages:
            raise NotImplementedError(
                "stage gangs wider than one worker are not wired yet: "
                f"world_size={ctx.world_size} != pipeline_stages={self.num_stages}")
        schedules = [schedule_interleaved_1f1b(self.num_stages, self.microbatches, s,
                                               self.virtual)
                     for s in range(self.num_stages)]
        validate_schedule(schedules, self.virtual)
        check_message_order(schedules, self.virtual)
        self.schedule = schedules[self.stage]
        self.wire = wire if wire is not None else _wire.ProcessGroupWire(point_to_point=True)
        if self.wire.size != self.num_stages or self.wire.rank != self.stage:
            raise ValueError(f"the wire is rank {self.wire.rank} of {self.wire.size}; stage "
                             f"{self.stage} of {self.num_stages} needs its own")
        self.activation_like = activation_like
        self.microbatch_fn = microbatch_fn

        stage_fns = (list(stage_fn) if isinstance(stage_fn, (list, tuple))
                     else [stage_fn] * self.virtual)
        chunk_params = list(params) if isinstance(params, (list, tuple)) else [params]
        if len(stage_fns) != self.virtual or len(chunk_params) != self.virtual:
            raise ValueError(
                f"need {self.virtual} stage_fns/param chunks (virtual={self.virtual}), got "
                f"{len(stage_fns)} fns / {len(chunk_params)} param trees")
        self._fns = stage_fns
        self._last_fn = last_stage_fn
        self._chunk_params = chunk_params
        self._leaves = [[leaf.requires_grad_(True) for _, leaf in tree_leaves(p)]
                        for p in chunk_params]
        self._optimizers = [optimizer(p) for p in chunk_params]
        self.device = self._leaves[0][0].device
        self.stats: dict[str, float] = {}

    def _virtual_stage(self, chunk: int) -> int:
        return chunk * self.num_stages + self.stage

    # -- timing -------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @contextlib.contextmanager
    def _phase(self, phase: str):
        """A ``step_annotation`` scope for ``phase`` (fwd, bwd or opt) that
        ends with the device synchronized, so the phase's kernels finish
        inside it; its seconds add to ``stats`` and to the StepStats
        split."""
        start = time.perf_counter()
        with step_annotation(phase, phase=phase):
            yield
            self._sync()
        self.stats[phase] += time.perf_counter() - start

    # -- the wire -------------------------------------------------------------
    def _recv(self, src: int, micro: Any) -> torch.Tensor:
        """Blocking neighbour receive; its wall time is the pipeline bubble
        at this stage (``stats`` and the "pp_bubble" phase)."""
        like = self.activation_like(micro)
        start = time.perf_counter()
        out = self.wire.recv(torch.empty(like.shape, dtype=like.dtype, device=self.device), src)
        self._sync()
        waited = time.perf_counter() - start
        self.stats["pp_bubble"] += waited
        record_phase("pp_bubble", waited)
        return out

    # -- the chunk's math ---------------------------------------------------
    def _vjp(self, chunk: int, a_in: torch.Tensor, ct: torch.Tensor):
        """(param grads, input grad or None): the chunk's forward recomputed
        from its stashed input under autograd."""
        leaves = self._leaves[chunk]
        with torch.enable_grad():
            a = a_in.detach().requires_grad_(a_in.is_floating_point())
            y = self._fns[chunk](self._chunk_params[chunk], a)
            inputs = leaves + ([a] if a.requires_grad else [])
            grads = torch.autograd.grad(y, inputs, grad_outputs=ct)
        return list(grads[:len(leaves)]), (grads[len(leaves)] if a.requires_grad else None)

    def _last_grad(self, chunk: int, a_in: torch.Tensor, micro: Any):
        """(loss, param grads, input grad) of the last virtual stage."""
        leaves = self._leaves[chunk]
        with torch.enable_grad():
            a = a_in.detach().requires_grad_(a_in.is_floating_point())
            loss = self._last_fn(self._chunk_params[chunk], a, micro)
            inputs = leaves + ([a] if a.requires_grad else [])
            grads = torch.autograd.grad(loss, inputs)
        return (loss.detach(), list(grads[:len(leaves)]),
                grads[len(leaves)] if a.requires_grad else None)

    # -- one optimizer step -------------------------------------------------
    def train_step(self, batch: Any) -> float:
        """Run this rank's op stream for one global batch and apply the
        chunk-local optimizer updates. Every rank returns the SAME mean
        microbatch loss (broadcast from the last rank)."""
        step_start = time.perf_counter()
        self.stats = {"fwd": 0.0, "bwd": 0.0, "opt": 0.0, "pp_bubble": 0.0}
        prev = (self.stage - 1) % self.num_stages
        nxt = (self.stage + 1) % self.num_stages
        last_vs = self.num_stages * self.virtual - 1
        grads_acc: list = [None] * self.virtual
        losses: list[torch.Tensor] = []
        stash: dict[tuple[int, int], Any] = {}
        for op, m, c in self.schedule:
            vs = self._virtual_stage(c)
            micro = self.microbatch_fn(batch, m, self.microbatches)
            if op == "F":
                if vs == 0:
                    a_in = torch.as_tensor(self._model_inputs(micro)).to(self.device)
                else:
                    a_in = self._recv(prev, micro)
                if vs == last_vs:
                    # No downstream cotangent to wait for: loss and grads
                    # at once, counted as backward (it dominates).
                    with self._phase("bwd"):
                        loss, dp, da = self._last_grad(c, a_in, micro)
                    losses.append(loss)
                    stash[(m, c)] = (dp, da)
                else:
                    stash[(m, c)] = a_in
                    with self._phase("fwd"), torch.no_grad():
                        y = self._fns[c](self._chunk_params[c], a_in)
                    self.wire.send(y, nxt)
            else:  # "B"
                if vs == last_vs:
                    dp, da = stash.pop((m, c))
                else:
                    ct = self._recv(nxt, micro)
                    with self._phase("bwd"):
                        dp, da = self._vjp(c, stash.pop((m, c)), ct)
                if vs > 0:
                    self.wire.send(da, prev)
                if grads_acc[c] is None:
                    grads_acc[c] = dp
                else:
                    grads_acc[c] = [a + g for a, g in zip(grads_acc[c], dp)]
        with self._phase("opt"):
            for c in range(self.virtual):
                for leaf, grad in zip(self._leaves[c], grads_acc[c]):
                    leaf.grad = grad / self.microbatches
                self._optimizers[c].step()
                self._optimizers[c].zero_grad(set_to_none=True)
        self.wire.flush()
        if self.stage == self.num_stages - 1:
            local = torch.stack(losses).float().mean().reshape(1)
        else:
            local = torch.zeros(1, dtype=torch.float32, device=self.device)
        loss = float(self.wire.broadcast(local, self.num_stages - 1)[0])
        self.stats["step"] = time.perf_counter() - step_start
        return loss

    def _model_inputs(self, micro: Any) -> Any:
        """What the first stage feeds its forward: the microbatch's
        inputs. Dict batches use 'x'/'inputs'/'tokens'; arrays pass
        through."""
        if isinstance(micro, dict):
            for key in ("x", "inputs", "tokens"):
                if key in micro:
                    return micro[key]
            raise KeyError("first-stage microbatch dict needs an 'x'/'inputs'/'tokens' entry")
        return micro


def microbatch_slicer(batch: Any, index: int, count: int) -> Any:
    """Default microbatch_fn: slice dim 0 of every leaf into ``count``
    equal chunks and take chunk ``index``."""
    def _slice(x):
        n = np.shape(x)[0]
        if n % count != 0:
            raise ValueError(f"batch dim {n} not divisible by microbatches={count}")
        size = n // count
        return x[index * size:(index + 1) * size]

    return tree_map(_slice, batch)
