"""Parameter trees between the JAX package (as numpy arrays) and the port.

The JAX side hands its parameters over as ``jax.tree.map(np.asarray, params)``:
a dict tree of numpy arrays, bf16 ones typed ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` cannot take. They go through float32, which holds every
bf16 value exactly.
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
