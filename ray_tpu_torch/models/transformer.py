"""LLaMA-style decoder-only transformer: the serving path, in PyTorch.

Port of ray_tpu's ``models/transformer.py``: the config, parameter init,
``forward`` and the KV-cache ``init_kv_cache`` / ``decode_step``. The
parameter tree keeps the JAX package's names and layouts (weights
``[in, out]`` used as ``h @ w``, the layer dim stacked first), so the JAX
parameters load one to one (``models/convert.py``).

  * Layers run as a Python loop over the stacked layer dim.
  * Attention goes through the flash-attention kernel (``attention="flash"``),
    the plain ``attention_reference`` (``"reference"``) or a callable.
  * Every norm goes through the RMSNorm kernel: 2 per layer and the final
    one, 65 launches per forward pass or decode step at 32 layers.
  * Weights default to bf16; norms, RoPE, SwiGLU and softmax math is f32.

Only inference exists in this module: the flash kernel has no backward yet,
so ``remat`` is kept as a config field and has no effect.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from ray_tpu_torch.ops.rmsnorm import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, clamp_index, rope_frequencies

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
    # Not ported yet: a config with moe set raises NotImplementedError.
    moe: MoEConfig | None = None
    # "flash" | "reference" | callable(q, k, v, causal) -> o
    attention: Any = "flash"
    # Rematerialization policy of the JAX package's training path: None,
    # "dots" or "full". Validated, and without effect under inference.
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
    if config.moe is not None:
        raise NotImplementedError("MoE layers are not ported to ray_tpu_torch yet")
    if config.remat not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {config.remat!r}")


def init_params(config: TransformerConfig, seed: int, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator``: the JAX
    package's distributions and scales (not its bits)."""
    _check_supported(config)
    device = resolve_device(device)
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

    return {
        "embed": dense(config.vocab_size, d, scale=0.02),
        "layers": {
            "attn_norm": ones(nl, d),
            "wq": dense(nl, d, q_out),
            "wk": dense(nl, d, kv_out),
            "wv": dense(nl, d, kv_out),
            "wo": dense(nl, q_out, d, scale=q_out ** -0.5),
            "mlp_norm": ones(nl, d),
            "w_gate": dense(nl, d, config.hidden_dim),
            "w_up": dense(nl, d, config.hidden_dim),
            "w_down": dense(nl, config.hidden_dim, d, scale=config.hidden_dim ** -0.5),
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
    ids reach the gather."""
    ids = clamp_index(torch.as_tensor(tokens), table.shape[0])
    return table[ids.to(table.device)]


def _layer(layers: dict, i: int) -> dict:
    return {name: w[i] for name, w in layers.items()}


def _attention_block(x, layer, config, cos_sin, positions, attention_fn):
    batch, seq, _ = x.shape
    hd = config.head_dim
    h = rmsnorm(x, layer["attn_norm"])
    q = (h @ layer["wq"]).view(batch, seq, config.n_heads, hd).transpose(1, 2)
    k = (h @ layer["wk"]).view(batch, seq, config.n_kv_heads, hd).transpose(1, 2)
    v = (h @ layer["wv"]).view(batch, seq, config.n_kv_heads, hd).transpose(1, 2)
    cos, sin = cos_sin
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    rep = config.n_heads // config.n_kv_heads
    o = attention_fn(q, _repeat_kv(k, rep), _repeat_kv(v, rep), True)
    o = o.transpose(1, 2).reshape(batch, seq, config.n_heads * hd)
    return x + (o @ layer["wo"]).to(x.dtype)


def _silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up with f32 math, stored in gate's dtype."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


def _dense_mlp(h: torch.Tensor, layer: dict) -> torch.Tensor:
    gate = (h @ layer["w_gate"]).to(h.dtype)
    up = (h @ layer["w_up"]).to(h.dtype)
    return _silu_mul(gate, up) @ layer["w_down"]


def forward(
    params: dict,
    tokens,
    config: TransformerConfig,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """tokens: [batch, seq] int -> logits [batch, seq, vocab] (f32)."""
    _check_supported(config)
    attention_fn = _attention_impl(config)
    embed = params["embed"]
    cos, sin = rope_frequencies(
        config.head_dim, config.max_seq, config.rope_theta, device=embed.device
    )
    x = _embed(embed, tokens)
    layers = params["layers"]
    for i in range(layers["wq"].shape[0]):
        layer = _layer(layers, i)
        x = _attention_block(x, layer, config, (cos, sin), positions, attention_fn)
        h = rmsnorm(x, layer["mlp_norm"])
        x = x + _dense_mlp(h, layer).to(x.dtype)
    x = rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"]).float()


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
    ``idx <= length`` mask.
    """
    _check_supported(config)
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
    layers = params["layers"]
    for i in range(layers["wq"].shape[0]):
        layer = _layer(layers, i)
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
