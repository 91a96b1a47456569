"""LLaMA-style decoder-only transformer, dense or mixture-of-experts, for
serving and training, in PyTorch.

Port of ray_tpu's ``models/transformer.py``: the config, parameter init and
logical dims, ``forward``, the MoE block (``_moe_mlp``), the loss
(``logits_loss``, ``loss_fn``), the pipeline-stage functions
(``partition_stages``, ``merge_stages``, ``stage_logical_dims``,
``stage_forward``) and the KV-cache ``init_kv_cache`` / ``decode_step``.
The parameter tree keeps the JAX package's names and layouts (weights
``[in, out]`` used as ``h @ w``, the layer dim stacked first), so the JAX
parameters load one to one (``models/convert.py``).

  * ``forward`` serves inference and training alike: under autograd the
    gradients flow through the flash kernels (forward, dQ, dK/dV) and the
    RMSNorm kernel's autograd Function. It is ``stage_forward`` of the one
    stage that holds every layer, so a chain of stages is the fused forward.
  * Layers run as a Python loop over the stacked layer dim, each under the
    config's remat policy when autograd records.
  * Attention goes through the flash-attention kernel (``attention="flash"``),
    the plain ``attention_reference`` (``"reference"``) or a callable.
  * Every norm goes through the RMSNorm kernel: 2 per layer and the final
    one, 65 launches per forward pass or decode step at 32 layers.
  * The MoE block routes with the reference's dense dispatch and combine
    tensors ``[tokens, experts, capacity]``; its einsums are matrix products
    (cuBLAS), as the JAX package leaves them to XLA.
  * Weights default to bf16 (the MoE router is f32); norms, RoPE, SwiGLU,
    routing and softmax math is f32.
  * ``decode_step`` runs dense models only: the reference's decode has no
    MoE branch.
  * Under the sharded train step (``train/torch_utils.py``) the blocks read
    its tensor-parallel context (``parallel/tensor_parallel.py``): each rank
    holds its column or row shards of the split weights and its share of
    the heads, and the blocks add Megatron's collectives; each ep rank
    holds its share of the MoE experts, whose outputs are summed over ep;
    the MoE routing and the masked loss run over the global batch across
    the data ranks. Without one they run as on one device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from ray_tpu_torch.ops.rmsnorm import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, clamp_index, rope_frequencies
from ray_tpu_torch.parallel import tensor_parallel as tp

_REMAT_POLICIES = (None, "dots", "full")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    moe: MoEConfig | None = None
    # "flash" | "reference" | callable(q, k, v, causal) -> o
    attention: Any = "flash"
    # Rematerialization of each layer under autograd: None saves every
    # activation, "full" recomputes the layer in the backward, "dots" saves
    # only the matrix products' outputs and recomputes the rest.
    remat: str | None = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**overrides) -> "TransformerConfig":
        base = dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq=128, dtype=torch.float32,
        )
        base.update(overrides)
        return TransformerConfig(**base)

    @staticmethod
    def llama2_7b(**overrides) -> "TransformerConfig":
        base = dict(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=32, hidden_dim=11008, max_seq=4096,
        )
        base.update(overrides)
        return TransformerConfig(**base)

    @staticmethod
    def llama_1b(**overrides) -> "TransformerConfig":
        """~1.2B params: 16 layers of 67M plus 131M of embedding and head."""
        base = dict(
            vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
            n_kv_heads=16, hidden_dim=8192, max_seq=2048, remat="dots",
        )
        base.update(overrides)
        return TransformerConfig(**base)


def _check_supported(config: TransformerConfig) -> None:
    if config.remat not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {config.remat!r}")


def param_logical_dims(config: TransformerConfig) -> dict:
    """Logical dim names per parameter leaf (layer-stacked leaves lead with
    "layer"), the JAX package's tree: what sharding rules map to mesh axes."""
    dense_mlp = {
        "w_gate": ("layer", "embed", "mlp"),
        "w_up": ("layer", "embed", "mlp"),
        "w_down": ("layer", "mlp", "embed"),
    }
    moe_mlp = {
        "router": ("layer", "embed", None),
        "w_gate": ("layer", "expert", "embed", "mlp"),
        "w_up": ("layer", "expert", "embed", "mlp"),
        "w_down": ("layer", "expert", "mlp", "embed"),
    }
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layer", None),
            "wq": ("layer", "embed", "heads"),
            "wk": ("layer", "embed", "kv"),
            "wv": ("layer", "embed", "kv"),
            "wo": ("layer", "heads", "embed"),
            "mlp_norm": ("layer", None),
            **(moe_mlp if config.moe else dense_mlp),
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def init_params(config: TransformerConfig, seed: int, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator``: the JAX
    package's distributions and scales (not its bits). On the ``meta``
    device, shapes and dtypes only: the plan of the sharded setup."""
    _check_supported(config)
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dt = config.dtype
    d, nl = config.dim, config.n_layers
    q_out = config.n_heads * config.head_dim
    kv_out = config.n_kv_heads * config.head_dim

    def dense(*shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w.mul_(scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    hidden = config.hidden_dim
    if config.moe:
        experts = config.moe.num_experts
        # The router is f32 in every model dtype (drawn in the model dtype
        # first, as the reference's is): its logits decide the routing.
        mlp = {
            "router": dense(nl, d, experts).float(),
            "w_gate": dense(nl, experts, d, hidden),
            "w_up": dense(nl, experts, d, hidden),
            "w_down": dense(nl, experts, hidden, d, scale=hidden ** -0.5),
        }
    else:
        mlp = {
            "w_gate": dense(nl, d, hidden),
            "w_up": dense(nl, d, hidden),
            "w_down": dense(nl, hidden, d, scale=hidden ** -0.5),
        }
    return {
        "embed": dense(config.vocab_size, d, scale=0.02),
        "layers": {
            "attn_norm": ones(nl, d),
            "wq": dense(nl, d, q_out),
            "wk": dense(nl, d, kv_out),
            "wv": dense(nl, d, kv_out),
            "wo": dense(nl, q_out, d, scale=q_out ** -0.5),
            "mlp_norm": ones(nl, d),
            **mlp,
        },
        "final_norm": ones(d),
        "lm_head": dense(d, config.vocab_size, scale=d ** -0.5),
    }


def _attention_impl(config: TransformerConfig) -> Callable:
    if callable(config.attention):
        return config.attention
    if config.attention == "flash":
        return lambda q, k, v, causal: flash_attention(q, k, v, causal=causal)
    return lambda q, k, v, causal: attention_reference(q, k, v, causal=causal)


def _repeat_kv(x: torch.Tensor, repeats: int) -> torch.Tensor:
    """Each kv head repeated in place (h0 h0 h1 h1 ...), not tiled."""
    if repeats == 1:
        return x
    return torch.repeat_interleave(x, repeats, dim=1)


def _embed(table: torch.Tensor, tokens) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``, with JAX's out-of-range rule (-1 is
    the last row, an id past the end the last row), applied before the
    ids reach the gather. Under tensor parallelism ``table`` is this rank's
    rows of the vocab: each rank looks up the ids it holds, zeros the
    others, and the ranks' rows are summed."""
    ctx = tp.current()
    if ctx is None:
        ids = clamp_index(torch.as_tensor(tokens), table.shape[0])
        return table[ids.to(table.device)]
    rows = table.shape[0]
    ids = clamp_index(torch.as_tensor(tokens), rows * ctx.size).to(table.device)
    local = ids - ctx.rank * rows
    mine = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)]
    return tp.reduce(torch.where(mine[..., None], out, torch.zeros_like(out)))


def _per_layer(layers: dict) -> list[dict]:
    """The stacked layer tree as one dict per layer. unbind, not indexing:
    its backward stacks the layers' gradients once."""
    names = list(layers)
    return [dict(zip(names, ws)) for ws in zip(*(layers[n].unbind(0) for n in names))]


def _attention_block(x, layer, config, cos_sin, positions, attention_fn):
    """Under tensor parallelism wq holds this rank's heads (columns) and wo
    their rows; wk and wv stay whole (``"kv"`` maps to no axis), so each
    rank computes every k and v head and keeps those its q heads read. The
    copy after the k and v products sums their gradients over the ranks,
    so wk's and wv's gradients come out whole on every rank, as the norm's
    do behind the copy of h."""
    batch, seq, _ = x.shape
    hd = config.head_dim
    first, heads = tp.local_heads(tp.current(), config.n_heads, layer["wq"].shape[-1] // hd)
    h = rmsnorm(x, layer["attn_norm"])
    q = (tp.copy(h) @ layer["wq"]).view(batch, seq, heads, hd).transpose(1, 2)
    k = tp.copy(h @ layer["wk"]).view(batch, seq, config.n_kv_heads, hd).transpose(1, 2)
    v = tp.copy(h @ layer["wv"]).view(batch, seq, config.n_kv_heads, hd).transpose(1, 2)
    cos, sin = cos_sin
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    rep = config.n_heads // config.n_kv_heads
    k, v = (_repeat_kv(t, rep)[:, first:first + heads] for t in (k, v))
    o = attention_fn(q, k, v, True)
    o = o.transpose(1, 2).reshape(batch, seq, heads * hd)
    return x + tp.reduce(o @ layer["wo"]).to(x.dtype)


class _SiluMul(torch.autograd.Function):
    """silu(gate) * up with f32 math and residency in the inputs' dtype: it
    saves only gate and up, and the backward recomputes the f32
    intermediates from them (the JAX model's ``jax.checkpoint``)."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return (F.silu(gate.float()) * up.float()).to(gate.dtype)

    @staticmethod
    def backward(ctx, dy):
        gate, up = ctx.saved_tensors
        g, dyf = gate.float(), dy.float()
        sig = torch.sigmoid(g)
        d_up = dyf * g * sig
        d_gate = dyf * up.float() * sig * (1.0 + g * (1.0 - sig))
        return d_gate.to(gate.dtype), d_up.to(up.dtype)


def _silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up with f32 math, stored in gate's dtype."""
    return _SiluMul.apply(gate, up)


def _dense_mlp(h: torch.Tensor, layer: dict) -> torch.Tensor:
    """SwiGLU; under tensor parallelism w_gate and w_up hold this rank's
    columns and w_down their rows."""
    h = tp.copy(h)
    gate = (h @ layer["w_gate"]).to(h.dtype)
    up = (h @ layer["w_up"]).to(h.dtype)
    return tp.reduce(_silu_mul(gate, up) @ layer["w_down"])


def moe_capacity(moe: MoEConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: the reference's
    ``max(1, int(capacity_factor * top_k * tokens / num_experts))``, in
    Python floats and in that order."""
    return max(1, int(moe.capacity_factor * moe.top_k * tokens / moe.num_experts))


def _moe_combine(ht: torch.Tensor, router: torch.Tensor, moe: MoEConfig,
                 ctx: tp.TPContext | None = None) -> torch.Tensor:
    """The combine tensor [tokens, experts, capacity] (f32) of top-k routing
    with the reference's rules: f32 router logits and softmax; for each of
    the top_k choices, the gate is the largest remaining probability (its
    gradient split equally among tied maxima, as ``jnp.max``'s) and the
    expert the first index of it; a token takes the next free slot of its
    expert, after every earlier choice's (the GShard occupancy offset), and
    is dropped past the capacity. f32 cumsum, exact to 2^24 tokens.

    In a sharded step with more than one data rank (``ctx``), ``ht`` is this
    rank's part of a batch split dp-major over the data axes, and the
    routing is the reference's over the global batch, as GSPMD runs it: the
    capacity comes from the global token count, and in each round every
    rank's per-expert counts are gathered, so that a token's slot follows
    every choice of its expert by the tokens of the ranks before it."""
    tokens, experts = ht.shape[0], moe.num_experts
    ranks = ctx.data_ranks if ctx is not None else 1
    capacity = moe_capacity(moe, tokens * ranks)
    probs = torch.softmax(ht.float() @ router.float(), dim=-1)  # [T, E]
    slots = torch.arange(capacity, device=ht.device)
    combine = probs.new_zeros(tokens, experts, capacity)
    occupancy = probs.new_zeros(experts)
    remaining = probs
    for _ in range(moe.top_k):
        gate = remaining.amax(dim=-1)
        choice = remaining.argmax(dim=-1)
        onehot = F.one_hot(choice, experts).to(probs.dtype)
        counts = onehot.sum(dim=0)
        if ranks > 1:
            every = tp.gather_data_ranks(counts.detach(), ctx)  # [ranks, E], dp-major
            before, counts = every[:ctx.data_rank].sum(dim=0), every.sum(dim=0)
            position = (torch.cumsum(onehot, dim=0) - 1.0 + occupancy + before) * onehot
        else:
            position = (torch.cumsum(onehot, dim=0) - 1.0 + occupancy) * onehot
        pos_idx = position.sum(dim=-1).to(torch.int32)
        keep = pos_idx < capacity
        # A slot index past the capacity matches no slot: an all-zero row,
        # as jax.nn.one_hot gives it.
        slot = (pos_idx[:, None] == slots).to(probs.dtype)
        combine = combine + (gate * keep)[:, None, None] * onehot[:, :, None] * slot[:, None, :]
        occupancy = occupancy + counts
        remaining = remaining * (1.0 - onehot)
    return combine


def _moe_mlp(h: torch.Tensor, layer: dict, config: TransformerConfig) -> torch.Tensor:
    """Dense dispatch/combine MoE (Mesh-TF style), the reference's: the
    dispatch is ``combine > 0`` in the model dtype, each expert runs
    SwiGLU on its capacity slots, and the combine, cast to the model dtype,
    weighs the experts' outputs back into the tokens.

    In a sharded step the routing runs over the global token order across
    the data ranks (``_moe_combine``); dispatch, the experts' products and
    the combine stay local, and the experts' gradients are reduced over the
    data axes by the step. Under ep and tp the block does what GSPMD's
    compiled step does with ``DEFAULT_RULES`` (read from the JAX package's
    step lowered on a CPU mesh of {dp 2, ep 4} and of {dp 2, tp 2, ep 2}):

      * the ep ranks of one data rank hold the same tokens and the same
        router, so each routes every token alike (GSPMD splits the
        routing's expert dim over ep; the port repeats the small routing
        on each ep rank instead) and keeps its own experts' columns of
        the combine;
      * each ep rank runs its experts' einsums on its data rank's dispatch;
        under tp, w_gate and w_up hold this rank's columns of every expert
        and w_down their rows, and the experts' outputs are summed over tp
        before the combine (GSPMD's all-reduce after ``ecm,emd->ecd``);
      * the combine's contraction over the experts is a sum over ep
        (``expert_sum``: GSPMD's all-reduce after ``tec,ecd->td``);
      * the block's input and the router are ``expert_copy``'d: each ep
        rank's backward covers its own experts, so their gradients, and
        every replicated leaf's before them, are summed over ep to the
        whole gradient (GSPMD's all-reduces in the transposed step)."""
    ctx = tp.current()
    moe = config.moe
    first, held = tp.local_experts(ctx, moe.num_experts, layer["w_gate"].shape[0])
    batch, seq, d = h.shape
    ht = tp.expert_copy(h.reshape(batch * seq, d))
    combine = _moe_combine(ht, tp.expert_copy(layer["router"]), moe, ctx)
    combine = combine[:, first:first + held]  # [T, E_local, C]
    dispatch = (combine > 0).to(h.dtype)
    expert_in = torch.einsum("tec,td->ecd", dispatch, tp.copy(ht))  # [E_local, C, D]
    gate = torch.einsum("ecd,edm->ecm", expert_in, layer["w_gate"]).to(h.dtype)
    up = torch.einsum("ecd,edm->ecm", expert_in, layer["w_up"]).to(h.dtype)
    expert_out = tp.reduce(torch.einsum("ecm,emd->ecd", _silu_mul(gate, up), layer["w_down"]))
    out = tp.expert_sum(torch.einsum("tec,ecd->td", combine.to(h.dtype), expert_out))
    return out.reshape(batch, seq, d)


def _layer_step(x, layer, config, cos_sin, positions, attention_fn):
    x = _attention_block(x, layer, config, cos_sin, positions, attention_fn)
    h = rmsnorm(x, layer["mlp_norm"])
    mlp = _moe_mlp(h, layer, config) if config.moe else _dense_mlp(h, layer)
    return x + mlp.to(x.dtype)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The counterpart of ``dots_with_no_batch_dims_saveable``: keep the
    outputs of the matrix products, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(step: Callable, policy: str | None) -> Callable:
    """``step`` under the remat policy: None, "full" or "dots"."""
    if policy is None:
        return step
    kwargs = {"use_reentrant": False}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(step, *args, **kwargs)


def forward(
    params: dict,
    tokens,
    config: TransformerConfig,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """tokens: [batch, seq] int -> logits [batch, seq, vocab] (f32)."""
    return stage_forward(params, tokens, config, first=True, last=True, positions=positions)


def logits_loss(
    logits: torch.Tensor, targets, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Token cross-entropy from logits [..., vocab]: the mean over tokens,
    or over the tokens where ``mask`` is set. f32 log-softmax.

    Inside a sharded step with more than one data rank, the masked mean is
    the reference's over the global batch: this rank's ``sum(nll * mask)``
    over the mask's count summed across the data ranks, clamped at 1, times
    the data ranks. The step averages every loss over the data ranks, so
    that this term's mean is the global masked mean, and a term added to
    it (a regulariser, an auxiliary loss) keeps its own mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = torch.as_tensor(targets, device=logits.device).long()
    nll = -logp.gather(-1, targets.unsqueeze(-1)).squeeze(-1)
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device).to(nll.dtype)
        count, ranks = tp.data_rank_sum(mask.sum().detach())
        return (nll * mask).sum() * ranks / count.clamp_min(1.0)
    return nll.mean()


def loss_fn(
    params: dict, tokens, targets, config: TransformerConfig,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    return logits_loss(forward(params, tokens, config), targets, mask)


def num_params(params: dict) -> int:
    leaves = [params["embed"], params["final_norm"], params["lm_head"],
              *params["layers"].values()]
    return sum(int(leaf.numel()) for leaf in leaves)


def config_num_params(config: TransformerConfig) -> int:
    """Parameter count from shapes alone."""
    d, hd = config.dim, config.head_dim
    attn = d * hd * (config.n_heads * 2 + config.n_kv_heads * 2)
    if config.moe:
        e = config.moe.num_experts
        mlp = d * e + 3 * e * d * config.hidden_dim
    else:
        mlp = 3 * d * config.hidden_dim
    per_layer = attn + mlp + 2 * d
    return config.n_layers * per_layer + 2 * config.vocab_size * d + d


# ---------------------------------------------------------------------------
# Pipeline stages (the JAX package's MPMD stage form)
# ---------------------------------------------------------------------------
def partition_stages(params: dict, config: TransformerConfig, num_stages: int) -> list[dict]:
    """Splits a full parameter tree into ``num_stages`` contiguous layer
    groups. Stage 0 also holds the embedding table, the last stage the
    final norm and the lm_head. The stages' layer leaves are views of the
    stacked leaves (no copy) and do not overlap, so per-stage updates
    compose to the fused update."""
    if config.n_layers % num_stages != 0:
        raise ValueError(f"n_layers={config.n_layers} not divisible by {num_stages} stages")
    per = config.n_layers // num_stages
    stages = []
    for s in range(num_stages):
        tree = {"layers": {name: leaf[s * per:(s + 1) * per]
                           for name, leaf in params["layers"].items()}}
        if s == 0:
            tree["embed"] = params["embed"]
        if s == num_stages - 1:
            tree["final_norm"] = params["final_norm"]
            tree["lm_head"] = params["lm_head"]
        stages.append(tree)
    return stages


def merge_stages(stage_trees: list[dict]) -> dict:
    """Inverse of ``partition_stages``: the fused tree, its layer leaves
    concatenated into new tensors."""
    layers = {name: torch.cat([t["layers"][name] for t in stage_trees], dim=0)
              for name in stage_trees[0]["layers"]}
    return {
        "embed": stage_trees[0]["embed"],
        "layers": layers,
        "final_norm": stage_trees[-1]["final_norm"],
        "lm_head": stage_trees[-1]["lm_head"],
    }


def stage_logical_dims(config: TransformerConfig, stage: int, num_stages: int) -> dict:
    """The part of ``param_logical_dims`` that matches one stage's tree."""
    full = param_logical_dims(config)
    tree = {"layers": full["layers"]}
    if stage == 0:
        tree["embed"] = full["embed"]
    if stage == num_stages - 1:
        tree["final_norm"] = full["final_norm"]
        tree["lm_head"] = full["lm_head"]
    return tree


def stage_forward(
    stage_params: dict,
    x,
    config: TransformerConfig,
    *,
    first: bool,
    last: bool,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Runs one pipeline stage's layers. First stage: ``x`` is int tokens
    [batch, seq], embedded first; other stages: activations [batch, seq,
    dim] from the stage before. The last stage also applies the final norm
    and the lm_head and returns f32 logits."""
    _check_supported(config)
    attention_fn = _attention_impl(config)
    layers = stage_params["layers"]
    cos, sin = rope_frequencies(
        config.head_dim, config.max_seq, config.rope_theta, device=layers["wq"].device
    )
    if first:
        x = _embed(stage_params["embed"], x)
    step = _remat(_layer_step, config.remat if torch.is_grad_enabled() else None)
    for layer in _per_layer(layers):
        x = step(x, layer, config, (cos, sin), positions, attention_fn)
    if last:
        x = rmsnorm(x, stage_params["final_norm"])
        # Under tensor parallelism the lm_head holds this rank's vocab
        # columns; the logits are gathered whole.
        x = tp.gather(tp.copy(x) @ stage_params["lm_head"]).float()
    return x


class Transformer(nn.Module):
    """Holds the parameters under the tree's names and calls ``forward``
    under ``torch.inference_mode()``."""

    def __init__(self, config: TransformerConfig, params: dict | None = None, *,
                 seed: int = 0, device=None):
        super().__init__()
        self.config = config
        if params is None:
            params = init_params(config, seed, device)

        def frozen(t):
            return nn.Parameter(t, requires_grad=False)

        self.embed = frozen(params["embed"])
        self.layers = nn.ParameterDict(
            {name: frozen(w) for name, w in params["layers"].items()}
        )
        self.final_norm = frozen(params["final_norm"])
        self.lm_head = frozen(params["lm_head"])

    def params(self) -> dict:
        return {
            "embed": self.embed,
            "layers": dict(self.layers.items()),
            "final_norm": self.final_norm,
            "lm_head": self.lm_head,
        }

    def forward(self, tokens, positions: torch.Tensor | None = None) -> torch.Tensor:
        with torch.inference_mode():
            return forward(self.params(), tokens, self.config, positions)


# ---------------------------------------------------------------------------
# KV-cache decode (serving path)
# ---------------------------------------------------------------------------
def init_kv_cache(config: TransformerConfig, batch: int, max_seq: int, device=None) -> dict:
    device = resolve_device(device)
    shape = (config.n_layers, batch, config.n_kv_heads, max_seq, config.head_dim)
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=device),
        "v": torch.zeros(shape, dtype=config.dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(
    params: dict, cache: dict, tokens, config: TransformerConfig
) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: [batch, 1] -> (logits [batch, vocab] f32,
    cache). One ``length`` is shared by the batch.

    The cache's k and v tensors are updated IN PLACE (the JAX version
    returns new arrays); the returned dict holds those same tensors and the
    new length, so callers use it as they would the JAX one. The write at
    ``length`` clamps to the last slot, as ``dynamic_update_slice`` clamps
    its start, and attention is f32 over the whole cache with the
    ``idx <= length`` mask. Dense models only: the reference's decode runs
    the dense MLP in every layer and has no MoE branch.
    """
    _check_supported(config)
    if config.moe is not None:
        raise NotImplementedError(
            "decode_step runs dense models only: the JAX reference's decode has no MoE "
            "branch (it calls the dense MLP in every layer)"
        )
    embed = params["embed"]
    device = embed.device
    cos, sin = rope_frequencies(
        config.head_dim, config.max_seq, config.rope_theta, device=device
    )
    hd = config.head_dim
    length = cache["length"]
    x = _embed(embed, tokens)
    batch = x.shape[0]
    positions = length.expand(batch, 1)
    k_all, v_all = cache["k"], cache["v"]
    cache_len = k_all.shape[3]
    write_at = length.clamp(max=cache_len - 1).long().view(1)
    visible = torch.arange(cache_len, device=device) <= length
    rep = config.n_heads // config.n_kv_heads
    for i, layer in enumerate(_per_layer(params["layers"])):
        k_cache, v_cache = k_all[i], v_all[i]
        h = rmsnorm(x, layer["attn_norm"])
        q = (h @ layer["wq"]).view(batch, 1, config.n_heads, hd).transpose(1, 2)
        k = (h @ layer["wk"]).view(batch, 1, config.n_kv_heads, hd).transpose(1, 2)
        v = (h @ layer["wv"]).view(batch, 1, config.n_kv_heads, hd).transpose(1, 2)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        k_cache.index_copy_(2, write_at, k.to(k_cache.dtype))
        v_cache.index_copy_(2, write_at, v.to(v_cache.dtype))
        keys = _repeat_kv(k_cache, rep).float()
        vals = _repeat_kv(v_cache, rep).float()
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), keys) * hd ** -0.5
        s = torch.where(visible, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vals)
        o = o.transpose(1, 2).reshape(batch, 1, config.n_heads * hd)
        x = x + (o.to(x.dtype) @ layer["wo"])
        h2 = rmsnorm(x, layer["mlp_norm"])
        x = x + _dense_mlp(h2, layer).to(x.dtype)
    x = rmsnorm(x, params["final_norm"])
    logits = (x[:, 0] @ params["lm_head"]).float()
    return logits, {"k": k_all, "v": v_all, "length": length + 1}
