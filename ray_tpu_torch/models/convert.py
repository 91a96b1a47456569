"""Parameter trees between the JAX package (as numpy arrays) and the port,
and the optimizer state between optax's layout and torch's.

The JAX side hands its parameters over as ``jax.tree.map(np.asarray, params)``:
a dict tree of numpy arrays, bf16 ones typed ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` cannot take. They go through float32, which holds every
bf16 value exactly.

``optax_adam_state`` / ``load_optax_adam_state`` map ``torch.optim.AdamW``
(and ``Adam``), as ``train.step.make_optimizer`` builds it, onto the state
``optax.adamw`` (and ``optax.adam``) keeps: the chain's first entry,
``ScaleByAdamState(count, mu, nu)``, then an empty state per further link
(adamw: add_decayed_weights, scale_by_learning_rate). A checkpoint holds it
under optax's key paths: ``opt_state.0.count`` (int32, torch's ``step``),
``opt_state.0.mu.<leaf>`` (``exp_avg``) and ``opt_state.0.nu.<leaf>``
(``exp_avg_sq``).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch import resolve_device


# Leaves that keep their dtype under params_from_numpy's ``dtype``: the MoE
# router is f32 in every model dtype, since its logits decide the routing.
_F32_LEAVES = ("router",)


def _map(fn, tree, key=None):
    """fn(leaf, key of the leaf) over a dict tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, value, k) for k, value in tree.items()}
    return fn(tree, key)


def _is_bf16(array: np.ndarray) -> bool:
    return array.dtype.name == "bfloat16"


def params_from_numpy(tree: dict, *, device=None, dtype: torch.dtype | None = None) -> dict:
    """numpy tree -> tree of tensors on ``device`` (cuda by default), each
    in its own dtype or in ``dtype`` when given; the MoE router keeps its
    own dtype either way."""
    device = resolve_device(device)

    def leaf(array, key) -> torch.Tensor:
        array = np.asarray(array)
        if _is_bf16(array):
            t = torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(array))  # a writable copy
        if dtype is not None and key not in _F32_LEAVES:
            t = t.to(dtype)
        return t.to(device)

    return _map(leaf, tree)


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_numpy``: bf16 tensors become
    ``ml_dtypes.bfloat16`` arrays, the others numpy arrays of their dtype."""

    def leaf(t: torch.Tensor, key) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.float().numpy().astype(ml_dtypes.bfloat16)
        return t.numpy()

    return _map(leaf, params)


def _chain_length(optimizer: torch.optim.Optimizer) -> int:
    """Links of the optax chain the optimizer stands for."""
    if isinstance(optimizer, torch.optim.AdamW):
        return 3
    if isinstance(optimizer, torch.optim.Adam):
        return 2
    raise NotImplementedError(
        f"{type(optimizer).__name__}: the port maps only AdamW and Adam onto optax's state")


def optax_adam_state(optimizer: torch.optim.Optimizer, params: dict) -> tuple:
    """The optimizer's state over the leaves of ``params`` in optax's
    layout: ``({"count", "mu", "nu"}, (), ...)``. A leaf the optimizer has
    not stepped yet has zero moments, as ``optax.adam(...).init`` gives."""
    steps = [st["step"] for st in optimizer.state.values() if "step" in st]
    count = int(steps[0]) if steps else 0

    def moment(name):
        return _map(lambda leaf, _: optimizer.state[leaf][name] if leaf in optimizer.state
                    else torch.zeros_like(leaf), params)

    adam = {"count": torch.tensor(count, dtype=torch.int32), "mu": moment("exp_avg"),
            "nu": moment("exp_avg_sq")}
    return (adam,) + ((),) * (_chain_length(optimizer) - 1)


def optax_adam_template(optimizer: torch.optim.Optimizer, params: dict) -> tuple:
    """The structure of ``optax_adam_state`` without its tensors: each leaf
    the parameter it belongs to (a template for ``checkpoint.load_pytree``)."""
    return ({"count": 0, "mu": params, "nu": params},) + ((),) * (_chain_length(optimizer) - 1)


def load_optax_adam_state(optimizer: torch.optim.Optimizer, params: dict, state: tuple,
                          place=None) -> None:
    """Sets the optimizer's state over ``params`` from optax's layout (as
    loaded): ``step`` from count, ``exp_avg`` from mu and ``exp_avg_sq``
    from nu. ``place(tensor, param)`` puts a loaded whole tensor where
    ``param`` lives (default: its device and dtype)."""
    place = place or (lambda t, leaf: t.to(device=leaf.device, dtype=leaf.dtype))
    adam = state[0]
    count = float(adam["count"])

    def load(leaf, mu, nu):
        optimizer.state[leaf] = {"step": torch.tensor(count, dtype=torch.float32),
                                 "exp_avg": place(mu, leaf), "exp_avg_sq": place(nu, leaf)}

    def walk(p, mu, nu):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], mu[k], nu[k])
        else:
            load(p, mu, nu)

    walk(params, adam["mu"], adam["nu"])
