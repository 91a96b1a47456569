"""The port's LoRA (``ray_tpu_torch/models/lora.py``) against the JAX
package's (``ray_tpu/models/lora.py``) on ``TransformerConfig.tiny()``.

The base weights come from the JAX init, the adapters from JAX's
``init_lora`` with B drawn at random (at init B is 0, where A's gradient
vanishes), both through ``params_from_numpy``; tokens are made with numpy
from a seed. The JAX side runs attention through its Pallas kernels in
interpret mode, the port its plain versions on CPU tensors. f32 bounds as
ROADMAP's parity rules set them: the forward and the loss at 2e-5, each
gradient at 2e-4, max |port - JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import lora as jl
from ray_tpu.models import transformer as jt
from ray_tpu_torch.models import lora as pl
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import load_optax_adam_state, optax_adam_state, params_from_numpy
from ray_tpu_torch.parallel.mesh import tree_leaves
from ray_tpu_torch.train.step import make_optimizer

F32_TOL = 2e-5
GRAD_F32_TOL = 2e-4
# After three AdamW(1e-4) steps each adapter within 1e-6 of optax's: a step
# moves an element by about lr, and f32 sums in another order move the
# gradients' last bits; a wrong gradient moves an element by up to lr.
STEP_TOL = 1e-6
STEPS = 3
TARGETS = [("wq", "wv"), ("wq", "wk", "wv", "wo")]


def _setup(targets=("wq", "wv"), random_b=True):
    jcfg, pcfg = jt.TransformerConfig.tiny(), pt.TransformerConfig.tiny()
    lcfg = jl.LoRAConfig(rank=4, targets=targets)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    jadapters = jl.init_lora(jcfg, lcfg, jax.random.PRNGKey(1))
    if random_b:
        rng = np.random.default_rng(7)
        jadapters = {t: {"a": ab["a"], "b": jnp.asarray(
            rng.standard_normal(ab["b"].shape).astype(np.float32) * 0.1)}
            for t, ab in jadapters.items()}
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    padapters = params_from_numpy(jax.tree.map(np.asarray, jadapters), device="cpu")
    plcfg = pl.LoRAConfig(rank=4, targets=targets)
    return (jcfg, jparams, jadapters, lcfg), (pcfg, pparams, padapters, plcfg)


def _tokens(shape=(2, 17), seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _max_err(port: torch.Tensor, ref) -> float:
    return float(np.max(np.abs(port.detach().numpy() - np.asarray(ref))))


def test_init_is_the_identity():
    """B = 0: the port's lora_forward is its forward bitwise, and JAX's
    within the f32 bound; A is N(0, 1/r^2), B zero, f32."""
    (jcfg, jparams, jadapters, lcfg), (pcfg, pparams, _, plcfg) = _setup(random_b=False)
    tokens = _tokens()[:, :-1]
    gen = torch.Generator().manual_seed(0)
    adapters = pl.init_lora(pcfg, plcfg, gen)
    assert set(adapters) == {"wq", "wv"}
    for ab, jab in zip(adapters.values(), jadapters.values()):
        assert ab["a"].shape == jab["a"].shape and ab["b"].shape == jab["b"].shape
        assert ab["a"].dtype == ab["b"].dtype == torch.float32
        assert not ab["b"].any()
        assert abs(float(ab["a"].std()) * plcfg.rank - 1.0) < 0.1
    with torch.no_grad():
        out = pl.lora_forward(pparams, adapters, torch.from_numpy(tokens), pcfg, plcfg)
        base = pt.forward(pparams, torch.from_numpy(tokens), pcfg)
    assert torch.equal(out, base)
    ref = jl.lora_forward(jparams, jadapters, jnp.asarray(tokens), jcfg, lcfg)
    assert _max_err(out, ref) < F32_TOL


@pytest.mark.parametrize("targets", TARGETS, ids=["wq_wv", "all_four"])
def test_merge_lora_matches_lora_forward_and_jax(targets):
    (jcfg, jparams, jadapters, lcfg), (pcfg, pparams, padapters, plcfg) = _setup(targets)
    merged = pl.merge_lora(pparams, padapters, plcfg)
    jmerged = jl.merge_lora(jparams, jadapters, lcfg)
    for target in targets:
        assert _max_err(merged["layers"][target], jmerged["layers"][target]) < F32_TOL
    assert merged["embed"] is pparams["embed"]
    tokens = torch.from_numpy(_tokens()[:, :-1])
    with torch.no_grad():
        via_merge = pt.forward(merged, tokens, pcfg)
        unmerged = pl.lora_forward(pparams, padapters, tokens, pcfg, plcfg)
    assert torch.equal(via_merge, unmerged)
    ref = jl.lora_forward(jparams, jadapters, jnp.asarray(tokens.numpy()), jcfg, lcfg)
    assert _max_err(unmerged, ref) < F32_TOL


def test_merge_casts_the_delta_before_the_add():
    """bf16 base: W + bf16(delta), the reference's rounding, not
    bf16(W + delta)."""
    lcfg = pl.LoRAConfig(rank=2, alpha=2.0, targets=("wq",))
    w = torch.full((1, 2, 2), 1.0, dtype=torch.bfloat16)
    a = torch.full((1, 2, 2), 0.5)
    # delta = 2^-8 + 2^-16 per element: bf16(delta) = 2^-8, a half ulp of
    # 1.0, so W + bf16(delta) rounds to even (1.0), where the f32 sum lies
    # above the half ulp and rounds up.
    b = torch.full((1, 2, 2), 2.0 ** -8 + 2.0 ** -16)
    merged = pl.merge_lora({"layers": {"wq": w}}, {"wq": {"a": a, "b": b}}, lcfg)
    delta = torch.einsum("lir,lro->lio", a, b)
    assert torch.equal(merged["layers"]["wq"], w + delta.to(torch.bfloat16))
    assert not torch.equal(merged["layers"]["wq"], (w.float() + delta).to(torch.bfloat16))
    jmerged = jl.merge_lora({"layers": {"wq": jnp.asarray(w.float().numpy(), jnp.bfloat16)}},
                            {"wq": {"a": jnp.asarray(a.numpy()), "b": jnp.asarray(b.numpy())}},
                            jl.LoRAConfig(rank=2, alpha=2.0, targets=("wq",)))
    np.testing.assert_array_equal(merged["layers"]["wq"].float().numpy(),
                                  np.asarray(jmerged["layers"]["wq"], np.float32))


@pytest.mark.parametrize("targets", TARGETS, ids=["wq_wv", "all_four"])
def test_loss_and_adapter_gradients_match_jax(targets):
    (jcfg, jparams, jadapters, lcfg), (pcfg, pparams, padapters, plcfg) = _setup(targets)
    tokens = _tokens()
    ref_loss, ref_grads = jax.value_and_grad(jl.lora_loss, argnums=1)(
        jparams, jadapters, jnp.asarray(tokens), jcfg, lcfg)
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_leaves(padapters)]
    loss = pl.lora_loss(pparams, padapters, torch.from_numpy(tokens), pcfg, plcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(ref_loss)) < F32_TOL
    for (path, _), grad in zip(tree_leaves(padapters), grads):
        ref = ref_grads[path[0]][path[1]]
        assert float(np.max(np.abs(np.asarray(ref)))) > 0, path
        assert _max_err(grad, ref) < GRAD_F32_TOL, path


def test_the_base_receives_no_gradient():
    """Base leaves that require grad still get none (the forward detaches
    them), and an optimizer over the adapters holds state for them alone."""
    _, (pcfg, pparams, padapters, plcfg) = _setup()
    for _, leaf in tree_leaves(pparams):
        leaf.requires_grad_(True)
    optimizer = make_optimizer(padapters, lr=1e-4)
    loss = pl.lora_loss(pparams, padapters, torch.from_numpy(_tokens()), pcfg, plcfg)
    loss.backward()
    assert all(leaf.grad is None for _, leaf in tree_leaves(pparams))
    assert all(leaf.grad is not None for _, leaf in tree_leaves(padapters))
    optimizer.step()
    assert len(optimizer.state) == len(list(tree_leaves(padapters)))


def test_three_adamw_steps_match_optax():
    """AdamW(1e-4), as release/train_llama_lora.py steps it (optax.adamw on
    the adapters, jax.value_and_grad of lora_loss), against the port's
    make_optimizer over the adapters: the losses, the adapters and the Adam
    moments in optax's layout (convert.optax_adam_state)."""
    (jcfg, jparams, jadapters, lcfg), (pcfg, pparams, padapters, plcfg) = _setup()
    batches = [_tokens(seed=10)] * STEPS  # one batch, as the release script steps
    opt = optax.adamw(1e-4)
    state = opt.init(jadapters)
    ref_losses = []
    for tok in batches:
        loss, grads = jax.value_and_grad(jl.lora_loss, argnums=1)(
            jparams, jadapters, jnp.asarray(tok), jcfg, lcfg)
        updates, state = opt.update(grads, state, jadapters)
        jadapters = optax.apply_updates(jadapters, updates)
        ref_losses.append(float(loss))
    optimizer = make_optimizer(padapters, lr=1e-4)
    losses = []
    for tok in batches:
        loss = pl.lora_loss(pparams, padapters, torch.from_numpy(tok), pcfg, plcfg)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=F32_TOL)
    assert losses[-1] < losses[0]
    for path, leaf in tree_leaves(padapters):
        assert _max_err(leaf, jadapters[path[0]][path[1]]) < STEP_TOL, path
    adam = optax_adam_state(optimizer, padapters)[0]
    assert int(adam["count"]) == int(state[0].count) == STEPS
    for moment in ("mu", "nu"):
        for path, leaf in tree_leaves(adam[moment]):
            ref = getattr(state[0], moment)[path[0]][path[1]]
            scale = float(np.max(np.abs(np.asarray(ref))))
            assert _max_err(leaf, ref) <= 1e-3 * scale, (moment, path)
    # The state goes back into a fresh optimizer unchanged.
    fresh = make_optimizer(padapters, lr=1e-4)
    load_optax_adam_state(fresh, padapters, optax_adam_state(optimizer, padapters))
    for leaf in fresh.state:
        assert torch.equal(fresh.state[leaf]["exp_avg"], optimizer.state[leaf]["exp_avg"])


@pytest.mark.parametrize("config", ["tiny", "llama2_7b"])
def test_num_lora_params_matches_jax(config):
    jcfg, pcfg = (getattr(m.TransformerConfig, config)() for m in (jt, pt))
    shapes = jax.eval_shape(lambda: jl.init_lora(jcfg, jl.LoRAConfig(), jax.random.PRNGKey(0)))
    adapters = pl.init_lora(pcfg, pl.LoRAConfig(), torch.Generator().manual_seed(0))
    assert pl.num_lora_params(adapters) == jl.num_lora_params(shapes)
    if config == "llama2_7b":  # 32 layers x 2 targets x (4096 x 8 + 8 x 4096)
        assert pl.num_lora_params(adapters) == 4_194_304
