"""The single-device train step: the port's counterpart of ``bench.py``'s.

    params = init_params(config, seed, device)
    optimizer = make_optimizer(params)
    loss = train_step(params, optimizer, tokens, config)   # tokens [batch, seq + 1]

The step is ``bench.py``'s: shifted next-token targets, the gradient of
``loss_fn`` by autograd, then AdamW with optax's ``adamw(3e-4)`` settings.
It stays functional in shape (a parameter dict, an optimizer over its
leaves), but the parameters and the optimizer state are updated IN PLACE:
that is the counterpart of the JAX step's ``donate_argnums=(0, 1)``, which
lets XLA reuse their buffers.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.models.transformer import TransformerConfig, loss_fn


def named_leaves(tree, prefix: str = ""):
    """(dotted name, leaf) of every leaf of a tree of dicts and lists (a
    list's items named by their index), in a fixed order."""
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for key, value in items:
        if isinstance(value, (dict, list)):
            yield from named_leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def make_optimizer(params: dict, lr: float = 3e-4) -> torch.optim.AdamW:
    """AdamW as ``optax.adamw(lr)`` sets it: betas (0.9, 0.999), eps 1e-8,
    weight decay 1e-4 (optax's default, not torch's 1e-2) on every leaf.
    Its state takes the parameters' dtype. Marks every leaf as requiring
    grad."""
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(params)]
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def train_step(
    params: dict, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
    config: TransformerConfig,
) -> torch.Tensor:
    """One step on tokens [batch, seq + 1]: inputs ``tokens[:, :-1]``,
    targets ``tokens[:, 1:]``. Updates params and optimizer state in place
    and returns the loss before the update, as a tensor on the device (no
    host sync)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    loss = loss_fn(params, inputs, targets, config)
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()
