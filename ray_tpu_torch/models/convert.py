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

``conv_params_from_numpy`` / ``conv_params_to_numpy`` carry the CNN and
ResNet trees of ``models/cnn.py`` across: the reference's HWIO conv
weights become OIHW and back, and the CNN's dense rows, which the
reference flattens in (height, width, channels) order, are permuted to the
port's (channels, height, width) order and back. LoRA adapters are plain
dict trees of f32 arrays and go through ``params_from_numpy``.

``rl_params_from_numpy`` / ``rl_params_to_numpy`` carry the RL modules'
trees (``rllib/core/rl_module.py``: ``MLPModule``, ``ConvModule``,
``LSTMModule``; ``rllib/algorithms/sac/sac.py``: ``SACModule``'s
``{"pi", "q1", "q2", "log_alpha"}`` with its 0-d ``log_alpha``) and the
learners' target trees (APPO's and DQN's copies of the params, SAC's
``{"q1", "q2"}``) across: ``ConvModule``'s HWIO conv weights become OIHW
and back; every other leaf keeps its layout (the port flattens the conv
map in the reference's (h, w, c) order, so ``trunk[0]``'s rows need no
permutation). Key order follows the tree given (``jax.device_get`` sorts
dict keys), so trees are matched by key, never by leaf order.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch import resolve_device


# Leaves that keep their dtype under params_from_numpy's ``dtype``: the MoE
# router is f32 in every model dtype, since its logits decide the routing.
_F32_LEAVES = ("router",)


def _map(fn, tree, key=None):
    """fn(leaf, key of the leaf) over a tree of dicts and lists (a list's
    items take the key the list has)."""
    if isinstance(tree, dict):
        return {k: _map(fn, value, k) for k, value in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, value, key) for value in tree]
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


def _conv_weights(tree, fn):
    """fn over every 4-d leaf named "w" (a conv weight) of a tree of dicts
    and lists; the other leaves as they are."""
    return _map(lambda leaf, key: fn(leaf) if key == "w" and leaf.ndim == 4 else leaf, tree)


def _dense_rows(rows: int, channels: int) -> tuple[int, int]:
    side = int(round((rows // channels) ** 0.5))
    if side * side * channels != rows:
        raise ValueError(f"a dense weight of {rows} rows is not a square map of {channels} "
                         "channels")
    return side, channels


def conv_params_from_numpy(tree: dict, *, device=None) -> dict:
    """A CNN or ResNet tree of the JAX package (numpy) -> the port's, on
    ``device`` (cuda by default): conv weights HWIO -> OIHW; the CNN's
    dense rows from (h, w, c) order to (c, h, w)."""
    tree = _conv_weights(tree, lambda w: np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))
    if "convs" in tree:
        w = np.asarray(tree["dense"]["w"])
        side, c = _dense_rows(w.shape[0], tree["convs"][-1]["w"].shape[0])
        w = w.reshape(side, side, c, -1).transpose(2, 0, 1, 3).reshape(w.shape)
        tree = {**tree, "dense": {**tree["dense"], "w": np.ascontiguousarray(w)}}
    return params_from_numpy(tree, device=device)


def conv_params_to_numpy(params: dict) -> dict:
    """Inverse of ``conv_params_from_numpy`` (a tree of gradients too)."""
    tree = _conv_weights(params_to_numpy(params), lambda w: w.transpose(2, 3, 1, 0))
    if "convs" in tree:
        w = tree["dense"]["w"]
        side, c = _dense_rows(w.shape[0], tree["convs"][-1]["w"].shape[-1])
        w = w.reshape(c, side, side, -1).transpose(1, 2, 0, 3).reshape(w.shape)
        tree = {**tree, "dense": {**tree["dense"], "w": w}}
    return tree


def rl_params_from_numpy(tree: dict, *, device=None) -> dict:
    """An RL module's tree of the JAX package (``jax.device_get`` of
    ``Learner.params``, or of a learner's target tree) -> the port's, f32
    on ``device`` (cuda by default)."""
    tree = _conv_weights(tree, lambda w: np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))
    return params_from_numpy(tree, device=device, dtype=torch.float32)


def rl_params_to_numpy(params: dict) -> dict:
    """Inverse of ``rl_params_from_numpy`` (a tree of gradients too)."""
    return _conv_weights(params_to_numpy(params), lambda w: w.transpose(2, 3, 1, 0))


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
        elif isinstance(p, list):
            for leaves in zip(p, mu, nu, strict=True):
                walk(*leaves)
        else:
            load(p, mu, nu)

    walk(params, adam["mu"], adam["nu"])
