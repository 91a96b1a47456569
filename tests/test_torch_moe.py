"""Parity of the port's MoE transformer (ray_tpu_torch.models.transformer,
``_moe_mlp`` and the model around it) with the JAX package's, on
TransformerConfig.tiny(moe=MoEConfig(num_experts=4, top_k=2)).

Weights come from the JAX init_params and go through params_from_numpy;
activations and tokens are made with numpy from a seed. The JAX side runs
attention="reference" on its CPU backend (one case runs its Pallas flash
kernel in interpret mode); the port runs its plain versions on CPU tensors.
The JAX routing tensors are read at the einsums that take them, as
tests/test_models.py reads the dispatch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.train import step as port_step
from ray_tpu_torch.train.step import named_leaves

# f32 forward (the MoE block's output and the model's logits): sums in
# another order, ~1e-6 at these sizes.
F32_TOL = 2e-5
# f32 gradients, max |port - JAX| per leaf (tests/test_ops.py's f32 bound).
GRAD_TOL = 2e-4
# After Adam steps, as tests/test_torch_train.py holds the dense model.
TRAJECTORY_LOSS_TOL = 1e-4
# Weights after 3 Adam steps, each against JAX's, to the dense test's 2e-6
# (tests/test_torch_train.py), but for at most 1 in 1000 of a leaf. The two
# sides' gradients agree to ~2e-7, but Adam's first update of a weight is
# lr * g / (|g| + 1e-8): a weight whose gradient is within rounding of zero
# (an expert weight few routed tokens touch, an lm_head entry where the
# tokens' terms cancel) gets an update whose size is then noise, up to
# 2 * lr (6e-4) a step apart. A wrong gradient moves most of a leaf.
TRAJECTORY_WEIGHT_TOL = 2e-6
NOISY_WEIGHT_SHARE = 1e-3


def _moe(**overrides):
    return {"moe_j": jt.MoEConfig(num_experts=4, top_k=2, **overrides),
            "moe_p": pt.MoEConfig(num_experts=4, top_k=2, **overrides)}


def _models(dtype="float32", attention="reference", seed=0, **moe_overrides):
    m = _moe(**moe_overrides)
    jcfg = jt.TransformerConfig.tiny(dtype=getattr(jnp, dtype), moe=m["moe_j"],
                                     attention=attention)
    pcfg = pt.TransformerConfig.tiny(dtype=getattr(torch, dtype), moe=m["moe_p"],
                                     attention="reference")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, pcfg, pparams


def _tokens(shape, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _err(port: torch.Tensor, ref) -> float:
    return float(np.max(np.abs(port.detach().float().numpy() - np.asarray(ref, np.float32))))


def _layer0(jparams):
    """Layer 0 of the stacked tree, as numpy arrays."""
    return {name: np.array(leaf[0]) for name, leaf in jparams["layers"].items()}


def _jax_moe(monkeypatch, h, layer, cfg):
    """JAX's _moe_mlp on h, with the dispatch and the combine it built."""
    captured = {}
    einsum = jnp.einsum

    def spy(spec, *args, **kwargs):
        if spec == "tec,td->ecd":
            captured["dispatch"] = np.asarray(args[0], np.float32)
        elif spec == "tec,ecd->td":
            captured["combine"] = np.asarray(args[0], np.float32)
        return einsum(spec, *args, **kwargs)

    monkeypatch.setattr(jnp, "einsum", spy)
    out = jt._moe_mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in layer.items()}, cfg)
    monkeypatch.setattr(jnp, "einsum", einsum)
    return np.asarray(out), captured["dispatch"], captured["combine"]


def _port_moe(h, layer, cfg):
    """The port's _moe_mlp on h, with its dispatch and combine."""
    ht = torch.from_numpy(h)
    tl = {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
    combine = pt._moe_combine(ht.reshape(-1, ht.shape[-1]), tl["router"], cfg.moe)
    return pt._moe_mlp(ht, tl, cfg), (combine > 0).float(), combine


@pytest.mark.parametrize("capacity_factor", [1.25, 2.0, 0.5], ids=["default", "roomy", "drops"])
def test_moe_mlp_routes_and_matches_jax(monkeypatch, capacity_factor):
    jcfg, jparams, pcfg, _ = _models(capacity_factor=capacity_factor)
    layer = _layer0(jparams)
    h = np.random.default_rng(2).standard_normal((2, 16, jcfg.dim)).astype(np.float32)
    ref, dispatch_j, combine_j = _jax_moe(monkeypatch, h, layer, jcfg)
    out, dispatch, combine = _port_moe(h, layer, pcfg)
    tokens = 2 * 16
    capacity = int(capacity_factor * 2 * tokens / 4)
    assert pt.moe_capacity(pcfg.moe, tokens) == capacity == dispatch_j.shape[-1]
    assert dispatch.shape == (tokens, 4, capacity)
    np.testing.assert_array_equal(dispatch.numpy(), dispatch_j)
    assert _err(combine, combine_j) < 1e-6
    assert out.shape == h.shape and _err(out, ref) < F32_TOL
    kept = int(dispatch.sum())
    if capacity_factor == 0.5:
        assert kept < 2 * tokens  # some choices found their expert full
    else:
        assert kept == 2 * tokens


def test_moe_no_slot_collision():
    """Mirrors tests/test_models.py: every (expert, slot) pair holds at most
    one token, and a token's second choice of an expert lands after every
    first choice of it."""
    cfg = pt.TransformerConfig.tiny(moe=pt.MoEConfig(num_experts=4, top_k=2,
                                                     capacity_factor=2.0))
    rng = np.random.default_rng(3)
    router = torch.from_numpy(rng.standard_normal((cfg.dim, 4)).astype(np.float32) * 0.5)
    ht = torch.from_numpy(rng.standard_normal((32, cfg.dim)).astype(np.float32))
    dispatch = (pt._moe_combine(ht, router, cfg.moe) > 0).float()
    assert float(dispatch.sum(dim=0).max()) <= 1.0
    assert float(dispatch.sum()) == 2 * 32


def test_moe_ties_go_to_the_first_expert_and_split_the_gradient(monkeypatch):
    """Two identical router columns tie in every token: the first choice is
    the lower index, the second the other, and the gate's gradient splits
    between the tied columns as jnp.max's does."""
    jcfg, jparams, pcfg, _ = _models(capacity_factor=2.0)
    layer = _layer0(jparams)
    router = np.random.default_rng(4).standard_normal((jcfg.dim, 4)).astype(np.float32) * 0.1
    router[:, 1] = router[:, 0] = np.abs(router[:, 2]) * 4.0
    layer["router"] = router
    h = np.abs(np.random.default_rng(5).standard_normal((1, 16, jcfg.dim))).astype(np.float32)
    ref, dispatch_j, _ = _jax_moe(monkeypatch, h, layer, jcfg)
    out, dispatch, combine = _port_moe(h, layer, pcfg)
    np.testing.assert_array_equal(dispatch.numpy(), dispatch_j)
    # Every token's first choice is expert 0 and its second expert 1, with
    # equal gates: slot t of each.
    gates = combine.sum(dim=-1)
    assert torch.equal(gates[:, 0], gates[:, 1]) and bool((gates[:, 0] > 0).all())
    assert torch.equal(dispatch[:, 0].argmax(-1), torch.arange(16))
    assert torch.equal(dispatch[:, 1].argmax(-1), torch.arange(16))
    assert _err(out, ref) < F32_TOL

    g = np.random.default_rng(6).standard_normal(h.shape).astype(np.float32)
    jlayer = {k: jnp.asarray(v) for k, v in layer.items()}

    def jax_objective(r, x):
        return jnp.sum(jt._moe_mlp(x, {**jlayer, "router": r}, jcfg) * g)

    dr_j, dh_j = jax.grad(jax_objective, argnums=(0, 1))(jnp.asarray(router), jnp.asarray(h))
    tl = {k: torch.from_numpy(v) for k, v in layer.items()}
    tl["router"].requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    objective = (pt._moe_mlp(ht, tl, pcfg) * torch.from_numpy(g)).sum()
    dr, dh = torch.autograd.grad(objective, (tl["router"], ht))
    assert _err(dr, dr_j) < GRAD_TOL and _err(dh, dh_j) < GRAD_TOL
    # The tied columns share the gate's gradient equally.
    assert float(dr[:, 0].abs().max()) > 0
    assert _err(dr[:, 0], np.asarray(dr_j)[:, 0]) < GRAD_TOL


@pytest.mark.parametrize("attention", ["reference", "flash"])
def test_moe_forward_matches_jax(attention):
    jcfg, jparams, pcfg, pparams = _models(attention=attention)
    tokens = _tokens((2, 32))
    ref = jt.forward(jparams, jnp.asarray(tokens), jcfg)
    out = pt.forward(pparams, torch.from_numpy(tokens), pcfg)
    assert out.dtype == torch.float32 and out.shape == (2, 32, 256)
    assert _err(out, ref) < F32_TOL


def test_moe_gradients_match_jax():
    jcfg, jparams, pcfg, pparams = _models()
    tokens = _tokens((2, 17))
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    loss_j, grads_j = jax.value_and_grad(jt.loss_fn)(
        jparams, jnp.asarray(inputs), jnp.asarray(targets), jcfg
    )
    leaves = dict(named_leaves(pparams))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss = pt.loss_fn(pparams, torch.from_numpy(inputs), torch.from_numpy(targets), pcfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(float(loss.detach()) - float(loss_j)) < F32_TOL
    refs = dict(named_leaves(grads_j))
    assert set(refs) == set(grads) and "layers.router" in grads
    for name, grad in grads.items():
        assert grad.dtype == leaves[name].dtype and grad.shape == leaves[name].shape, name
        assert _err(grad, refs[name]) < GRAD_TOL, (name, _err(grad, refs[name]))
    assert float(grads["layers.router"].abs().max()) > 0


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_moe_remat_gives_the_same_gradients(remat):
    _, _, pcfg, pparams = _models()
    tokens = torch.from_numpy(_tokens((2, 17)))
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(pparams)]

    def grads(cfg):
        loss = pt.loss_fn(pparams, tokens[:, :-1], tokens[:, 1:], cfg)
        return torch.autograd.grad(loss, leaves)

    for a, b in zip(grads(pcfg), grads(dataclasses.replace(pcfg, remat=remat))):
        assert float((a - b).abs().max()) <= 1e-7


def test_moe_train_step_trajectory_matches_jax():
    """Three steps of the tiny MoE on one batch: the port's train_step
    against bench.py's step with optax.adamw(3e-4)."""
    jcfg, jparams, pcfg, pparams = _models()
    tokens = _tokens((2, 17))
    optimizer = optax.adamw(3e-4)

    @jax.jit
    def step(params, opt_state, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        loss, grads = jax.value_and_grad(jt.loss_fn)(params, inputs, targets, jcfg)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    opt_state = optimizer.init(jparams)
    port_opt = port_step.make_optimizer(pparams)
    tokens_t = torch.from_numpy(tokens)
    for i in range(3):
        jparams, opt_state, loss_j = step(jparams, opt_state, jnp.asarray(tokens))
        loss = port_step.train_step(pparams, port_opt, tokens_t, pcfg)
        assert abs(float(loss) - float(loss_j)) < TRAJECTORY_LOSS_TOL, i
    refs = dict(named_leaves(jparams))
    for name, got in named_leaves(pparams):
        ref = np.asarray(refs[name], np.float32)
        assert got.shape == ref.shape, name
        err = np.abs(got.detach().numpy() - ref)
        noisy = int((err > TRAJECTORY_WEIGHT_TOL).sum())
        assert noisy <= NOISY_WEIGHT_SHARE * err.size, (name, noisy, err.size)
        assert float(err.max()) < 3 * 2 * 3e-4, name


def test_moe_init_params_layout():
    jcfg, _, pcfg, _ = _models("bfloat16")
    params = pt.init_params(pcfg, seed=0, device="cpu")
    jshapes = jax.tree.map(
        lambda a: (a.shape, str(a.dtype)),
        jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0))),
    )
    dtypes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert jax.tree.map(lambda t: (tuple(t.shape), dtypes[t.dtype]), params) == jshapes
    assert params["layers"]["router"].dtype == torch.float32
    assert pt.num_params(params) == pt.config_num_params(pcfg) == jt.config_num_params(jcfg)


def test_params_from_numpy_keeps_the_router_f32():
    _, jparams, _, _ = _models()
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    layers = params["layers"]
    assert layers["router"].dtype == torch.float32
    np.testing.assert_array_equal(layers["router"].numpy(), tree["layers"]["router"])
    assert all(t.dtype == torch.bfloat16 for name, t in layers.items() if name != "router")
    assert params["embed"].dtype == torch.bfloat16


def test_moe_decode_step_is_refused():
    """The reference's decode runs the dense MLP in every layer."""
    _, _, pcfg, pparams = _models()
    cache = pt.init_kv_cache(pcfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        pt.decode_step(pparams, cache, torch.zeros(1, 1, dtype=torch.int64), pcfg)
