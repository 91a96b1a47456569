"""Parity of the port's training path (loss, gradients, remat, train step)
with the JAX package's, on small configs.

Weights come from the JAX init_params and go through params_from_numpy;
tokens, logits and masks are made with numpy from a seed. The JAX side
runs attention through its Pallas flash kernels (forward, dQ, dK/dV) in
interpret mode; the port runs its plain versions on CPU tensors.
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

# f32 losses of size ~5: sums over tokens and vocab in another order.
LOSS_TOL = 1e-5
# After Adam steps the two sides' weights differ by ~1e-7 (sums in another
# order move the updates' last bits), which moves the loss by ~1e-5; each
# step itself moves the loss by ~0.5.
TRAJECTORY_LOSS_TOL = 1e-4
# Relative Frobenius error of each gradient leaf. f32: the two frameworks
# sum in other orders through 2 layers (~1e-6). bf16: they round at other
# places (fused against eager), a few bf16 ulps (2^-8 each) per element,
# adding with random signs (~2e-2); a wrong gradient is off by order 1.
GRAD_F32_TOL = 2e-5
GRAD_BF16_TOL = 5e-2


def _models(dtype="float32", seed=0, **overrides):
    jcfg = jt.TransformerConfig.tiny(dtype=getattr(jnp, dtype), **overrides)
    pcfg = pt.TransformerConfig.tiny(dtype=getattr(torch, dtype), **overrides)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, pcfg, pparams


def _tokens(shape, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _rel(port: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    diff = port.detach().float().numpy() - ref
    return float(np.linalg.norm(diff) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked_mean"])
def test_logits_loss_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 8, 256)).astype(np.float32) * 3
    targets = rng.integers(0, 256, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) > 0.4).astype(np.float32) if masked else None
    ref = jt.logits_loss(jnp.asarray(logits), jnp.asarray(targets),
                         None if mask is None else jnp.asarray(mask))
    out = pt.logits_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                         None if mask is None else torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == ()
    assert abs(float(out) - float(ref)) < LOSS_TOL


def test_masked_loss_of_an_empty_mask_is_zero():
    logits = torch.zeros(1, 4, 8)
    out = pt.logits_loss(logits, torch.zeros(1, 4, dtype=torch.int64), torch.zeros(1, 4))
    assert float(out) == 0.0


def test_loss_fn_matches_jax():
    jcfg, jparams, pcfg, pparams = _models()
    tokens = _tokens((2, 17))
    ref = jt.loss_fn(jparams, jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:]), jcfg)
    out = pt.loss_fn(pparams, torch.from_numpy(tokens[:, :-1]),
                     torch.from_numpy(tokens[:, 1:]), pcfg)
    assert abs(float(out) - float(ref)) < LOSS_TOL


@pytest.mark.parametrize("dtype,tol", [("float32", GRAD_F32_TOL), ("bfloat16", GRAD_BF16_TOL)])
def test_model_gradients_match_jax(dtype, tol):
    """tiny() has 4 heads over 2 kv heads: the kv gradients sum over each
    group through the repeat."""
    jcfg, jparams, pcfg, pparams = _models(dtype)
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
    assert abs(float(loss.detach()) - float(loss_j)) < (LOSS_TOL if dtype == "float32" else 1e-2)
    refs = dict(named_leaves(grads_j))
    assert set(refs) == set(grads)
    for name, grad in grads.items():
        assert grad.dtype == leaves[name].dtype and grad.shape == leaves[name].shape, name
        assert _rel(grad, refs[name]) < tol, (name, _rel(grad, refs[name]))


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_same_gradients(remat):
    _, _, pcfg, pparams = _models()
    tokens = torch.from_numpy(_tokens((2, 17)))
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(pparams)]

    def grads(cfg):
        loss = pt.loss_fn(pparams, tokens[:, :-1], tokens[:, 1:], cfg)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    loss_saved, saved = grads(pcfg)
    loss_remat, recomputed = grads(dataclasses.replace(pcfg, remat=remat))
    assert loss_remat == loss_saved
    # Recomputing runs the same ops on the same inputs.
    for a, b in zip(saved, recomputed):
        assert float((a - b).abs().max()) <= 1e-7


def test_train_step_trajectory_matches_jax():
    """Three steps of tiny f32 on one batch: the port's train_step against
    bench.py's step with optax.adamw(3e-4)."""
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
        assert not loss.requires_grad
        assert abs(float(loss) - float(loss_j)) < TRAJECTORY_LOSS_TOL, i
    # An Adam update moves each weight by about lr (3e-4); the two sides'
    # weights agree to ~3e-7 after 3 steps. Torch's default weight decay
    # (1e-2, not optax's 1e-4) would move the norm weights (1.0) by 9e-6.
    refs = dict(named_leaves(jparams))
    for name, got in named_leaves(pparams):
        ref = np.asarray(refs[name], np.float32)
        assert got.shape == ref.shape, name
        assert float(np.max(np.abs(got.detach().numpy() - ref))) < 2e-6, name


def test_train_step_updates_params_in_place():
    _, _, pcfg, pparams = _models()
    optimizer = port_step.make_optimizer(pparams)
    (group,) = optimizer.param_groups
    assert group["lr"] == 3e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 1e-4
    wq = pparams["layers"]["wq"]
    before = wq.detach().clone()
    port_step.train_step(pparams, optimizer, torch.from_numpy(_tokens((2, 9))), pcfg)
    assert pparams["layers"]["wq"] is wq and not torch.equal(wq.detach(), before)
    assert all(leaf.grad is None for leaf in group["params"])
    assert optimizer.state[wq]["exp_avg"].dtype == wq.dtype
