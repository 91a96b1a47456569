"""LoRA: low-rank adapters for the transformer, in PyTorch.

Port of ray_tpu's ``models/lora.py`` (BASELINE config 5, the Llama-2-7B
LoRA fine-tune of ``release/train_llama_lora.py``). Adapters target the
attention projections (wq and wv by default): the effective weight is
W + (alpha / r) A @ B with A [d_in, r] and B [r, d_out], stacked over the
layers as the base weights are. Only the adapters train; the base stays in
its dtype (bf16 at 7B) and takes no gradient.

  * ``merge_lora`` rounds the f32 delta to the base dtype before the add,
    as the reference does: ``W + bf16(delta)``, not ``bf16(W + delta)``.
    The adapters' gradient flows back through that cast.
  * ``lora_forward`` detaches the base (the reference's ``stop_gradient``)
    and runs the model's ``forward`` on the merged weights, so attention
    and every norm run through the flash and RMSNorm kernels, forward and
    backward. The base leaves should not require grad at all: build the
    optimizer over the adapters alone (``train.step.make_optimizer(
    adapters)``), or a 7B base gets gradients and AdamW state. With the
    embedding frozen, layer 0's first norm and its k projection take no
    gradient; the kernels' autograd Functions skip what autograd does not
    ask for.
  * ``lora_loss`` is the reference's own next-token NLL over
    ``tokens[:, :-1]`` and ``tokens[:, 1:]``, an f32 log-softmax and a mean.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ray_tpu_torch.models.transformer import TransformerConfig, forward
from ray_tpu_torch.parallel.mesh import tree_leaves, tree_map


@dataclasses.dataclass
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Sequence[str] = ("wq", "wv")


def init_lora(model_config: TransformerConfig, lora_config: LoRAConfig,
              generator: torch.Generator) -> dict:
    """A ~ N(0, 1/r^2) (a standard normal times 1/r), B = 0: the adapters
    start as the identity (the paper's init), in f32 on ``generator``'s
    device, drawn from it target by target."""
    d, hd = model_config.dim, model_config.head_dim
    out_dims = {
        "wq": model_config.n_heads * hd,
        "wk": model_config.n_kv_heads * hd,
        "wv": model_config.n_kv_heads * hd,
        "wo": d,
    }
    nl, r = model_config.n_layers, lora_config.rank
    device = generator.device
    adapters = {}
    for target in lora_config.targets:
        d_in = out_dims["wo"] if target == "wo" else d
        d_out = out_dims[target]
        a = torch.randn((nl, d_in, r), generator=generator, dtype=torch.float32, device=device)
        adapters[target] = {
            "a": a * (1.0 / r),
            "b": torch.zeros((nl, r, d_out), dtype=torch.float32, device=device),
        }
    return adapters


def merge_lora(params: dict, adapters: dict, lora_config: LoRAConfig) -> dict:
    """The base params with the adapters folded in: W + (alpha / r) A @ B,
    the f32 delta cast to W's dtype before the add. New tensors for the
    targets, the other leaves shared with ``params``."""
    scale = lora_config.alpha / lora_config.rank
    layers = dict(params["layers"])
    for target, ab in adapters.items():
        delta = torch.einsum("lir,lro->lio", ab["a"], ab["b"]) * scale
        base = params["layers"][target]
        layers[target] = base + delta.to(base.dtype)
    return {**params, "layers": layers}


def lora_forward(params: dict, adapters: dict, tokens, config: TransformerConfig,
                 lora_config: LoRAConfig) -> torch.Tensor:
    """Logits [batch, seq, vocab] (f32) of the model with the adapters
    applied; gradients reach the adapters only."""
    frozen = tree_map(lambda leaf: leaf.detach(), params)
    return forward(merge_lora(frozen, adapters, lora_config), tokens, config)


def lora_loss(params: dict, adapters: dict, tokens, config: TransformerConfig,
              lora_config: LoRAConfig) -> torch.Tensor:
    """Next-token cross entropy of tokens [batch, seq + 1]: the mean NLL of
    ``tokens[:, 1:]`` given ``tokens[:, :-1]``."""
    tokens = torch.as_tensor(tokens)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = lora_forward(params, adapters, inputs, config, lora_config)
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = targets.to(logits.device).long()
    nll = -logp.gather(-1, targets.unsqueeze(-1)).squeeze(-1)
    return nll.mean()


def num_lora_params(adapters: dict) -> int:
    return sum(int(leaf.numel()) for _, leaf in tree_leaves(adapters))
