"""Parity of the port's ops (ray_tpu_torch.ops) with the JAX package's.

The same numpy inputs, made from a seed, go through both. The JAX side runs
its Pallas kernels as tests/test_ops.py runs them (interpret mode on the
CPU); the port side runs the plain versions on CPU tensors. Tolerances are
those of tests/test_ops.py: 2e-5 for f32, 3e-2 for bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jax_flash
from ray_tpu.ops import rmsnorm as jax_rmsnorm
from ray_tpu.ops import rope as jax_rope
from ray_tpu_torch.ops import flash_attention as port_flash
from ray_tpu_torch.ops import rmsnorm as port_rmsnorm
from ray_tpu_torch.ops import rope as port_rope

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _max_err(port: torch.Tensor, ref) -> float:
    return float(np.max(np.abs(port.float().numpy() - np.asarray(ref, np.float32))))


def test_rope_tables_match_jax():
    cos_j, sin_j = jax_rope.rope_frequencies(64, 128)
    cos_p, sin_p = port_rope.rope_frequencies(64, 128, device="cpu")
    assert cos_p.dtype == sin_p.dtype == torch.float32
    # f32 pow and cos of two libraries agree to a few ulps at these angles.
    assert _max_err(cos_p, cos_j) < F32_TOL
    assert _max_err(sin_p, sin_j) < F32_TOL


@pytest.mark.parametrize(
    "positions",
    [None, [[3, 7, 0, 127], [1, 2, 3, 4]], [[-1, 130, 5, 1000], [0, -3, 64, 128]]],
    ids=["implicit", "explicit", "out_of_range"],
)
def test_apply_rope_matches_jax(positions):
    cos_j, sin_j = jax_rope.rope_frequencies(64, 128)
    cos_p, sin_p = port_rope.rope_frequencies(64, 128, device="cpu")
    x = _normal(0, 2, 3, 4, 64)
    pos_j = None if positions is None else jnp.asarray(positions, jnp.int32)
    pos_p = None if positions is None else torch.tensor(positions, dtype=torch.int32)
    ref = jax_rope.apply_rope(jnp.asarray(x), cos_j, sin_j, pos_j)
    out = port_rope.apply_rope(torch.from_numpy(x), cos_p, sin_p, pos_p)
    assert out.dtype == torch.float32
    assert _max_err(out, ref) < F32_TOL


def test_apply_rope_bf16_keeps_dtype():
    cos_j, sin_j = jax_rope.rope_frequencies(32, 16)
    cos_p, sin_p = port_rope.rope_frequencies(32, 16, device="cpu")
    x = _normal(1, 1, 2, 16, 32)
    ref = jax_rope.apply_rope(jnp.asarray(x, jnp.bfloat16), cos_j, sin_j)
    out = port_rope.apply_rope(torch.from_numpy(x).bfloat16(), cos_p, sin_p)
    assert out.dtype == torch.bfloat16
    assert _max_err(out, ref.astype(jnp.float32)) < BF16_TOL


@pytest.mark.parametrize(
    "shape,dtype,tol",
    [
        ((4, 128, 512), "float32", 1e-5),
        ((7, 512), "float32", 1e-5),  # odd rows: the JAX wrapper's fallback
        ((3, 5, 256), "bfloat16", 1e-2),
    ],
    ids=["f32", "odd_rows", "bf16"],
)
def test_rmsnorm_matches_jax(shape, dtype, tol):
    x = _normal(3, *shape)
    w = _normal(4, shape[-1])
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    ref = jax_rmsnorm.rmsnorm(xj, wj, block_rows=4)
    tdtype = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(tdtype), torch.from_numpy(w).to(tdtype)
    out = port_rmsnorm.rmsnorm(xt, wt)
    assert out.dtype == tdtype and out.shape == xt.shape
    assert _max_err(out, ref.astype(jnp.float32)) < tol
    # On the CPU the wrapper is its plain version, exactly.
    assert torch.equal(out, port_rmsnorm.rmsnorm_reference(xt, wt))


# (batch, heads, seq_q, seq_k, head_dim, causal, dtype, block_q, block_k):
# the shapes of tests/test_ops.py, with the JAX kernel's blocks there.
FLASH_CASES = {
    "s256_d64_causal": (2, 4, 256, 256, 64, True, "float32", 64, 64),
    "s256_d64_full": (2, 4, 256, 256, 64, False, "float32", 64, 64),
    "s128_d32": (1, 2, 128, 128, 32, True, "float32", 128, 32),
    "sq64_sk128": (1, 2, 64, 128, 32, True, "float32", 32, 32),
    "bf16_s128_d64": (1, 2, 128, 128, 64, True, "bfloat16", 64, 64),
}


def _flash_inputs(case):
    b, h, sq, sk, d, causal, dtype, bq, bk = FLASH_CASES[case]
    q, k, v = _normal(10, b, h, sq, d), _normal(11, b, h, sk, d), _normal(12, b, h, sk, d)
    jax_in = [jnp.asarray(a, dtype) for a in (q, k, v)]
    port_in = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    return jax_in, port_in, causal, tol, (bq, bk)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_jax(case):
    (qj, kj, vj), (qt, kt, vt), causal, tol, (bq, bk) = _flash_inputs(case)
    ref = jax_flash.flash_attention(qj, kj, vj, causal=causal, block_q=bq, block_k=bk)
    out = port_flash.flash_attention(qt, kt, vt, causal=causal)
    assert out.shape == qt.shape and out.dtype == qt.dtype
    assert _max_err(out, ref.astype(jnp.float32)) < tol


@pytest.mark.parametrize("case", ["s256_d64_causal", "sq64_sk128"])
def test_flash_lse_matches_jax(case):
    (qj, kj, vj), (qt, kt, vt), causal, tol, (bq, bk) = _flash_inputs(case)
    _, lse_j = jax_flash._flash_forward(qj, kj, vj, causal=causal, block_q=bq, block_k=bk)
    out, lse = port_flash._flash_forward(qt, kt, vt, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == qt.shape[:3]
    # LSE values are ~log(seq) + O(1); relative f32 error stays ~1e-7.
    assert _max_err(lse, lse_j) < 1e-4
    assert torch.equal(out, port_flash.flash_attention(qt, kt, vt, causal=causal))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches_jax(causal):
    q, k, v = _normal(20, 1, 2, 32, 64), _normal(21, 1, 2, 48, 64), _normal(22, 1, 2, 48, 64)
    ref = jax_flash.attention_reference(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    out = port_flash.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal
    )
    assert _max_err(out, ref) < F32_TOL


def test_flash_attention_rejects_unrepeated_kv_heads():
    q = torch.zeros(1, 4, 8, 32)
    kv = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="repeat kv heads"):
        port_flash.flash_attention(q, kv, kv)
