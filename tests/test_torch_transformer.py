"""Parity of the port's transformer (ray_tpu_torch.models.transformer) with
the JAX package's, on TransformerConfig.tiny() (GQA: 4 heads, 2 kv heads).

Weights come from the JAX init_params and go through params_from_numpy;
tokens are made with numpy from a seed. The JAX side runs attention through
its Pallas flash kernel in interpret mode; the port runs its plain versions
on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

# f32: the two frameworks sum in other orders; 2 layers keep that ~1e-5.
F32_LOGITS_TOL = 1e-4
# bf16: rounding at other points (fused vs eager) moves logits of size ~5
# by a few bf16 ulps; a wrong model is off by O(1).
BF16_LOGITS_TOL = 0.15
# decode (f32 attention over the cache) against forward (flash), as
# tests/test_models.py holds them.
DECODE_VS_FORWARD_TOL = 1e-3


def _models(dtype="float32", seed=0):
    jcfg = jt.TransformerConfig.tiny(dtype=getattr(jnp, dtype))
    pcfg = pt.TransformerConfig.tiny(dtype=getattr(torch, dtype))
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, pcfg, pparams


def _tokens(shape, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _err(port, ref) -> float:
    return float(np.max(np.abs(port.float().numpy() - np.asarray(ref, np.float32))))


@pytest.mark.parametrize(
    "dtype,tol", [("float32", F32_LOGITS_TOL), ("bfloat16", BF16_LOGITS_TOL)]
)
def test_forward_matches_jax(dtype, tol):
    jcfg, jparams, pcfg, pparams = _models(dtype)
    tokens = _tokens((2, 32))
    ref = jt.forward(jparams, jnp.asarray(tokens), jcfg)
    out = pt.forward(pparams, torch.from_numpy(tokens), pcfg)
    assert out.dtype == torch.float32 and out.shape == (2, 32, 256)
    assert _err(out, ref) < tol


def test_forward_with_positions_matches_jax():
    jcfg, jparams, pcfg, pparams = _models()
    tokens = _tokens((2, 8))
    positions = np.array([[5 + i for i in range(8)], [40 + i for i in range(8)]], np.int32)
    ref = jt.forward(jparams, jnp.asarray(tokens), jcfg, jnp.asarray(positions))
    out = pt.forward(pparams, torch.from_numpy(tokens), pcfg, torch.from_numpy(positions))
    assert _err(out, ref) < F32_LOGITS_TOL


@pytest.mark.parametrize("attention", ["reference", "callable"])
def test_attention_switch(attention):
    _, _, pcfg, pparams = _models()
    tokens = torch.from_numpy(_tokens((1, 16)))
    flash = pt.forward(pparams, tokens, pcfg)
    calls = []

    def custom(q, k, v, causal):
        calls.append(q.shape)
        return pt.attention_reference(q, k, v, causal=causal)

    chosen = custom if attention == "callable" else "reference"
    out = pt.forward(pparams, tokens, pt.TransformerConfig.tiny(attention=chosen))
    assert float((out - flash).abs().max()) < F32_LOGITS_TOL
    assert len(calls) == (2 if attention == "callable" else 0)


def test_embedding_clamps_out_of_range_ids():
    jcfg, jparams, pcfg, pparams = _models()
    tokens = np.array([[-1, 3, 257, 255]], np.int32)  # -1 and vocab + 1
    ref = jt.forward(jparams, jnp.asarray(tokens), jcfg)
    out = pt.forward(pparams, torch.from_numpy(tokens), pcfg)
    assert _err(out, ref) < F32_LOGITS_TOL
    # -1 is the last row; vocab + 1 clamps to the last row too.
    last_row = pt.forward(pparams, torch.tensor([[255]]), pcfg)[0, 0]
    assert float((out[0, 0] - last_row).abs().max()) < F32_LOGITS_TOL
    rows = pt._embed(pparams["embed"], torch.tensor([-1, 5, -300, 300]))
    expect = pparams["embed"][[255, 5, 0, 255]]
    assert torch.equal(rows, expect)


def test_decode_matches_jax_step_by_step():
    """Logits and cache after every step, with two steps past the cache's
    end (the write clamps to the last slot on both sides)."""
    jcfg, jparams, pcfg, pparams = _models()
    batch, cache_len, steps = 2, 6, 8
    tokens = _tokens((batch, steps))
    jcache = jt.init_kv_cache(jcfg, batch, cache_len)
    pcache = pt.init_kv_cache(pcfg, batch, cache_len, device="cpu")
    for i in range(steps):
        step = tokens[:, i : i + 1]
        jlogits, jcache = jt.decode_step(jparams, jcache, jnp.asarray(step), jcfg)
        plogits, pcache = pt.decode_step(pparams, pcache, torch.from_numpy(step), pcfg)
        assert plogits.shape == (batch, 256) and plogits.dtype == torch.float32
        assert _err(plogits, jlogits) < F32_LOGITS_TOL, i
        assert _err(pcache["k"], jcache["k"]) < F32_LOGITS_TOL, i
        assert _err(pcache["v"], jcache["v"]) < F32_LOGITS_TOL, i
        assert int(pcache["length"]) == int(jcache["length"]) == i + 1


def test_decode_updates_cache_in_place():
    _, _, pcfg, pparams = _models()
    cache = pt.init_kv_cache(pcfg, 1, 4, device="cpu")
    k_before = cache["k"]
    _, new = pt.decode_step(pparams, cache, torch.tensor([[7]]), pcfg)
    assert new["k"] is k_before and float(k_before[:, :, :, 0].abs().sum()) > 0
    assert int(cache["length"]) == 0 and int(new["length"]) == 1


def test_decode_matches_forward():
    """As tests/test_models.py holds the JAX decode against its forward."""
    _, _, pcfg, pparams = _models()
    tokens = torch.from_numpy(_tokens((2, 8)))
    cache = pt.init_kv_cache(pcfg, 2, 16, device="cpu")
    for i in range(8):
        logits, cache = pt.decode_step(pparams, cache, tokens[:, i : i + 1], pcfg)
    full = pt.forward(pparams, tokens, pcfg)[:, -1]
    assert float((logits - full).abs().max()) < DECODE_VS_FORWARD_TOL


def test_params_roundtrip_and_counts():
    jcfg, jparams, pcfg, pparams = _models("bfloat16")
    back = params_to_numpy(pparams)
    for (path, ref), got in zip(
        jax.tree_util.tree_flatten_with_path(jparams)[0], jax.tree.leaves(back)
    ):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(np.asarray(ref, np.float32), got.astype(np.float32))
    assert pt.num_params(pparams) == jt.num_params(jparams)
    assert pt.config_num_params(pcfg) == jt.config_num_params(jcfg)


def test_init_params_layout_and_scales():
    cfg = pt.TransformerConfig.tiny(n_layers=3)
    params = pt.init_params(cfg, seed=0, device="cpu")
    jshapes = jax.tree.map(
        lambda a: a.shape,
        jax.eval_shape(lambda: jt.init_params(jt.TransformerConfig.tiny(n_layers=3),
                                              jax.random.PRNGKey(0))),
    )
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jshapes
    layers = params["layers"]
    assert float(layers["wq"].std()) == pytest.approx(cfg.dim ** -0.5, rel=0.1)
    assert float(params["embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(layers["attn_norm"], torch.ones(3, cfg.dim))
    again = pt.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["lm_head"], params["lm_head"])
    assert not torch.equal(pt.init_params(cfg, seed=1, device="cpu")["lm_head"],
                           params["lm_head"])


def test_transformer_module_matches_forward():
    _, _, pcfg, pparams = _models()
    model = pt.Transformer(pcfg, pparams)
    tokens = torch.from_numpy(_tokens((1, 12)))
    assert torch.equal(model(tokens), pt.forward(pparams, tokens, pcfg))
    assert set(model.state_dict()) == {
        "embed", "final_norm", "lm_head", *(f"layers.{k}" for k in pparams["layers"])
    }


def test_moe_and_bad_remat_are_refused():
    # The reference's decode has no MoE branch, so the port's refuses one.
    moe = pt.TransformerConfig.tiny(moe=pt.MoEConfig())
    params = pt.init_params(moe, 0, device="cpu")
    cache = pt.init_kv_cache(moe, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        pt.decode_step(params, cache, torch.zeros(1, 1, dtype=torch.int64), moe)
    _, _, _, pparams = _models()
    with pytest.raises(ValueError, match="remat"):
        pt.forward(pparams, torch.zeros(1, 4, dtype=torch.int64),
                   pt.TransformerConfig.tiny(remat="bogus"))
