"""Parity of the port's ops (ray_tpu_torch.ops) with the JAX package's.

The same numpy inputs, made from a seed, go through both. The JAX side runs
its Pallas kernels as tests/test_ops.py runs them (interpret mode on the
CPU); the port side runs the plain versions on CPU tensors. Tolerances are
those of tests/test_ops.py: 2e-5 for f32, 3e-2 for bf16 on the forward;
2e-4 for f32 (at Precision.HIGHEST) and 0.15 for bf16 on the gradients.
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
GRAD_F32_TOL = 2e-4
GRAD_BF16_TOL = 0.15


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


# fesetround's code for round-down (toward -inf) on x86-64 glibc.
_FE_DOWNWARD = 0x400


def test_rope_tables_ignore_the_threads_rounding_mode():
    """The tables must not depend on the calling thread's floating-point
    rounding mode: a library that leaves it set to round-down moved f32
    tables by 1.1e-4 at (64, 128)."""
    import ctypes

    libm = ctypes.CDLL("libm.so.6")
    cos_j, sin_j = jax_rope.rope_frequencies(64, 128)
    before = libm.fegetround()
    if libm.fesetround(_FE_DOWNWARD) != 0:
        pytest.skip("libm refused round-down")
    try:
        cos_p, sin_p = port_rope.rope_frequencies(64, 128, device="cpu")
    finally:
        libm.fesetround(before)
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
    # TransformerConfig.tiny()'s attention: head_dim 16.
    "tiny_s32_d16": (2, 4, 32, 32, 16, True, "float32", 32, 32),
    # Gemma's head_dim, the widest the kernels are built for, and one the
    # wrapper pads to it on the card.
    "s128_d256": (1, 2, 128, 128, 256, True, "float32", 64, 64),
    "bf16_s128_d256": (1, 2, 128, 128, 256, True, "bfloat16", 64, 64),
    "sq64_sk128_d192": (1, 2, 64, 128, 192, True, "float32", 32, 64),
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


def _flash_grads_jax(qj, kj, vj, do, causal, blocks, *, precision):
    def f(q, k, v):
        return jax_flash.flash_attention(
            q, k, v, causal=causal, block_q=blocks[0], block_k=blocks[1], precision=precision
        )

    _, vjp = jax.vjp(f, qj, kj, vj)
    return vjp(jnp.asarray(do, qj.dtype))


@pytest.mark.parametrize("case", ["s256_d64_causal", "s256_d64_full", "sq64_sk128",
                                  "bf16_s128_d64", "s128_d256", "bf16_s128_d256",
                                  "sq64_sk128_d192"])
def test_flash_gradients_match_jax(case):
    (qj, kj, vj), (qt, kt, vt), causal, _, blocks = _flash_inputs(case)
    bf16 = qt.dtype == torch.bfloat16
    do = _normal(13, *qt.shape)
    precision = None if bf16 else jax.lax.Precision.HIGHEST
    refs = _flash_grads_jax(qj, kj, vj, do, causal, blocks, precision=precision)
    leaves = [t.requires_grad_(True) for t in (qt, kt, vt)]
    out = port_flash.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(qt.dtype))
    tol = GRAD_BF16_TOL if bf16 else GRAD_F32_TOL
    for got, ref, leaf in zip(grads, refs, leaves):
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        assert _max_err(got, ref.astype(jnp.float32)) < tol


@pytest.mark.parametrize("case", ["s256_d64_causal", "sq64_sk128", "bf16_s128_d64"])
def test_flash_backward_on_explicit_inputs_matches_jax(case):
    """The plain backward and JAX's _flash_backward (its Pallas dQ and dK/dV
    kernels) on the same (q, k, v, O, LSE, dO)."""
    (qj, kj, vj), (qt, kt, vt), causal, _, (bq, bk) = _flash_inputs(case)
    bf16 = qt.dtype == torch.bfloat16
    out_j, lse_j = jax_flash._flash_forward(qj, kj, vj, causal=causal, block_q=bq, block_k=bk)
    do = _normal(14, *qt.shape)
    scale = qt.shape[-1] ** -0.5
    refs = jax_flash._flash_backward(
        qj, kj, vj, out_j, lse_j, jnp.asarray(do, qj.dtype), causal=causal, scale=scale,
        block_q=bq, block_k=bk, interpret=None,
        precision=None if bf16 else jax.lax.Precision.HIGHEST,
    )
    out = torch.from_numpy(np.array(out_j, np.float32)).to(qt.dtype)
    lse = torch.from_numpy(np.array(lse_j))
    grads = port_flash._flash_backward_reference(
        qt, kt, vt, out, lse, torch.from_numpy(do), causal=causal, scale=scale
    )
    tol = GRAD_BF16_TOL if bf16 else GRAD_F32_TOL
    for got, ref in zip(grads, refs):
        assert got.dtype == qt.dtype
        assert _max_err(got, ref.astype(jnp.float32)) < tol
    # On the CPU the wrapper is its plain version, exactly.
    again = port_flash._flash_backward(qt, kt, vt, out, lse, torch.from_numpy(do), causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


@pytest.mark.parametrize("seq_q,seq_k", [(130, 70), (37, 200), (100, 100)])
def test_flash_gradients_are_the_plain_derivative(seq_q, seq_k):
    """Ragged lengths and, at 130 x 70, rows that see no key: the flash
    gradients equal autograd through attention_reference (f32 sums in
    another order)."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, 32), np.float32))
               for n in (seq_q, seq_k, seq_k))
    do = torch.from_numpy(rng.standard_normal((1, 2, seq_q, 32), np.float32))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(port_flash.flash_attention(*leaves), leaves, do)
    plain = torch.autograd.grad(port_flash.attention_reference(*leaves), leaves, do)
    for got, want in zip(grads, plain):
        assert float((got - want).abs().max()) < 1e-5
    if seq_q > seq_k:  # rows that see no key: no dQ, dO / seq_k into every dV row
        blind = seq_q - seq_k
        assert float(grads[0][:, :, :blind].abs().max()) == 0.0


@pytest.mark.parametrize(
    "dtype,shape",
    [("float32", (3, 16, 256)), ("bfloat16", (3, 16, 256)),
     ("float32", (7, 4096)), ("bfloat16", (7, 4096))],
    ids=["float32", "bfloat16", "float32-train_width", "bfloat16-train_width"],
)
def test_rmsnorm_gradients_match_jax(dtype, shape):
    """dx and dw of the norm's autograd Function against jax.vjp of
    rmsnorm_reference on the same x, w and dy, at a small width and at the
    train step's (dim 4096, an odd row count)."""
    x, w, dy = _normal(30, *shape), _normal(31, shape[-1]), _normal(32, *shape)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    _, vjp = jax.vjp(jax_rmsnorm.rmsnorm_reference, xj, wj)
    dxj, dwj = vjp(jnp.asarray(dy, dtype))
    tdtype = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(tdtype).requires_grad_(True)
    dx, dw = torch.autograd.grad(port_rmsnorm.rmsnorm(xt, wt), (xt, wt),
                                 torch.from_numpy(dy).to(tdtype))
    assert dx.dtype == dw.dtype == tdtype
    dxj, dwj = np.asarray(dxj, np.float32), np.asarray(dwj, np.float32)
    if dtype == "float32":
        # f32 sums of up to 4096 (dx) and 48 (dw) terms in another order.
        assert _max_err(dx, dxj) < 1e-5 and _max_err(dw, dwj) < 1e-4
    else:
        # Each rounds once to bf16 from nearly equal f32 values: one ulp of
        # the largest magnitude at most.
        for got, ref in ((dx, dxj), (dw, dwj)):
            assert _max_err(got, ref) <= np.abs(ref).max() * 2.0 ** -8
    # On the CPU the backward wrapper is its plain version, exactly.
    plain = port_rmsnorm._rmsnorm_backward(xt.detach(), wt.detach(),
                                           torch.from_numpy(dy).to(tdtype), 1e-6)
    assert torch.equal(dx, plain[0]) and torch.equal(dw, plain[1])


@pytest.mark.parametrize(
    "head_dim,size",
    [(8, 16), (16, 16), (17, 32), (48, 64), (64, 64), (80, 128), (96, 128), (128, 128),
     (129, 256), (192, 256), (256, 256), (257, 384), (320, 384), (384, 384), (512, 512),
     (513, 640)],
)
def test_padded_head_dim(head_dim, size):
    # Above 256 the kernels take every multiple of 128.
    assert port_flash.padded_head_dim(head_dim) == size


@pytest.mark.parametrize("head_dim", [0, -1, -256])
def test_a_head_dim_no_kernel_holds_is_refused(head_dim):
    with pytest.raises(ValueError, match="head_dim"):
        port_flash.padded_head_dim(head_dim)


@pytest.mark.parametrize(
    "head_dim,causal,seq_q,seq_k",
    [(8, True, 40, 56), (48, False, 33, 20), (80, True, 100, 160), (80, False, 100, 160),
     (96, True, 70, 50), (192, True, 100, 160), (192, False, 70, 50), (320, True, 100, 160),
     (300, False, 70, 50)],
    ids=["d8_causal", "d48_full", "d80_causal", "d80_full", "d96_blind_rows", "d192_causal",
         "d192_full", "d320_causal", "d300_blind_rows"],
)
def test_zero_padding_the_head_is_exact(head_dim, causal, seq_q, seq_k):
    """The kernels' wrappers run a head_dim they are not built for padded
    with zero columns to padded_head_dim, at the true head_dim's scale, and
    slice the result back. On the plain versions that rule gives the
    unpadded O, LSE and gradients, zeros in the padding, and JAX's
    attention at that head_dim."""
    rng = np.random.default_rng(40)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 3, n, head_dim), np.float32))
                   for n in (seq_q, seq_k, seq_k, seq_q))
    size, scale = port_flash.padded_head_dim(head_dim), head_dim ** -0.5

    def pad(t):
        return port_flash._pad_head(t, size)

    out = port_flash.attention_reference(q, k, v, causal=causal)
    lse = port_flash._lse_reference(q, k, causal=causal, scale=scale)
    out_p = port_flash.attention_reference(pad(q), pad(k), pad(v), causal=causal, scale=scale)
    lse_p = port_flash._lse_reference(pad(q), pad(k), causal=causal, scale=scale)
    # Zero columns add exact zeros to every score: f32 sums of the same
    # terms, in a blocked order that the width may change.
    assert float((out_p[..., :head_dim] - out).abs().max()) < 1e-6
    assert float((lse_p - lse).abs().max()) < 1e-6
    assert not out_p[..., head_dim:].any()
    ref = jax_flash.attention_reference(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                        causal=causal)
    assert _max_err(out_p[..., :head_dim], ref) < F32_TOL

    grads = port_flash._flash_backward_reference(q, k, v, out, lse, do, causal=causal,
                                                 scale=scale)
    grads_p = port_flash._flash_backward_reference(pad(q), pad(k), pad(v), out_p, lse_p,
                                                   pad(do), causal=causal, scale=scale)
    for got, want in zip(grads_p, grads):
        assert float((got[..., :head_dim] - want).abs().max()) < 1e-6
        assert not got[..., head_dim:].any()


# (shape, x dtype, weight dtype): a dim that is no whole number of 16-byte
# pieces, f16, and a weight in another dtype than x, which the kernels take
# on their scalar route and the plain versions as the reference does.
RMSNORM_OTHER_INPUTS = {
    "d50_f32": ((3, 7, 50), "float32", "float32"),
    "d50_bf16": ((5, 50), "bfloat16", "bfloat16"),
    "d64_f16": ((4, 64), "float16", "float16"),
    "bf16_x_f32_w": ((6, 256), "bfloat16", "float32"),
    "f16_x_bf16_w_d50": ((3, 50), "float16", "bfloat16"),
}


def _one_rounding(dtype: str, ref: np.ndarray) -> float:
    """The bound for two results that round nearly equal f32 values once:
    one ulp of the largest magnitude in a 16-bit dtype; f32 sums in another
    order otherwise."""
    bits = {"bfloat16": 8, "float16": 11}.get(dtype)
    return np.abs(ref).max() * 2.0 ** -bits if bits else 1e-4


@pytest.mark.parametrize("case", list(RMSNORM_OTHER_INPUTS))
def test_rmsnorm_takes_every_input_the_reference_takes(case):
    """Forward and gradients of the norm against JAX's rmsnorm_reference
    (f32 math, y and dx in x's dtype, dw in the weight's)."""
    shape, xdtype, wdtype = RMSNORM_OTHER_INPUTS[case]
    x, w, dy = _normal(50, *shape), _normal(51, shape[-1]), _normal(52, *shape)
    xj, wj = jnp.asarray(x, xdtype), jnp.asarray(w, wdtype)
    ref, vjp = jax.vjp(jax_rmsnorm.rmsnorm_reference, xj, wj)
    dxj, dwj = vjp(jnp.asarray(dy, xdtype))
    xt = torch.from_numpy(x).to(getattr(torch, xdtype)).requires_grad_(True)
    wt = torch.from_numpy(w).to(getattr(torch, wdtype)).requires_grad_(True)
    out = port_rmsnorm.rmsnorm(xt, wt)
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dy).to(xt.dtype))
    assert out.dtype == dx.dtype == xt.dtype and dw.dtype == wt.dtype
    for got, want, dtype in ((out, ref, xdtype), (dx, dxj, xdtype), (dw, dwj, wdtype)):
        want = np.asarray(want, np.float32)
        assert _max_err(got.detach(), want) <= _one_rounding(dtype, want)
