"""Parity of the port's pipeline-stage functions and logical dims
(ray_tpu_torch.models.transformer: param_logical_dims, partition_stages,
merge_stages, stage_logical_dims, stage_forward) with the JAX package's.

Weights come from the JAX init_params and go through params_from_numpy;
tokens are made with numpy from a seed. The JAX side runs its Pallas flash
kernel in interpret mode; the port runs its plain versions on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.train.step import named_leaves

# A chain of stages against the fused forward, f32: the bound
# tests/test_train.py holds the pipeline's loss trajectory to.
CHAIN_TOL = 2e-6
# One stage against JAX's stage on the same input, f32: sums in another
# order through up to 2 layers (and the head).
STAGE_TOL = 2e-5


def _configs(moe: bool, n_layers: int = 4):
    jmoe = jt.MoEConfig(num_experts=4, top_k=2) if moe else None
    pmoe = pt.MoEConfig(num_experts=4, top_k=2) if moe else None
    return (jt.TransformerConfig.tiny(n_layers=n_layers, moe=jmoe),
            pt.TransformerConfig.tiny(n_layers=n_layers, moe=pmoe))


def _models(moe: bool, n_layers: int = 4):
    jcfg, pcfg = _configs(moe, n_layers)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, pcfg, pparams


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _err(port: torch.Tensor, ref) -> float:
    return float(np.max(np.abs(port.detach().float().numpy() - np.asarray(ref, np.float32))))


def _chain(stages, tokens, cfg):
    x = tokens
    for s, tree in enumerate(stages):
        x = pt.stage_forward(tree, x, cfg, first=s == 0, last=s == len(stages) - 1)
    return x


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_param_logical_dims_match_jax(moe):
    jcfg, pcfg = _configs(moe)
    dims = pt.param_logical_dims(pcfg)
    assert dims == jt.param_logical_dims(jcfg)
    # One name per dim of every leaf.
    params = pt.init_params(pcfg, 0, device="cpu")
    shapes = dict(named_leaves(params))
    for name, names in named_leaves(dims):
        assert len(names) == shapes[name].dim(), name


@pytest.mark.parametrize("num_stages", [1, 2, 4])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_stage_logical_dims_match_jax(moe, num_stages):
    jcfg, pcfg = _configs(moe)
    for stage in range(num_stages):
        assert (pt.stage_logical_dims(pcfg, stage, num_stages)
                == jt.stage_logical_dims(jcfg, stage, num_stages))


@pytest.mark.parametrize("num_stages", [2, 4])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_partition_matches_jax_and_merge_restores(moe, num_stages):
    jcfg, jparams, pcfg, pparams = _models(moe)
    stages = pt.partition_stages(pparams, pcfg, num_stages)
    jstages = jt.partition_stages(jparams, jcfg, num_stages)
    assert len(stages) == len(jstages) == num_stages
    for s, (tree, jtree) in enumerate(zip(stages, jstages)):
        got, want = dict(named_leaves(tree)), dict(named_leaves(jtree))
        assert set(got) == set(want), s
        for name, leaf in got.items():
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[name]), err_msg=name)
        assert set(tree) == set(pt.stage_logical_dims(pcfg, s, num_stages))
    merged = pt.merge_stages(stages)
    original = dict(named_leaves(pparams))
    for name, leaf in named_leaves(merged):
        assert leaf.dtype == original[name].dtype and torch.equal(leaf, original[name]), name
    assert set(dict(named_leaves(merged))) == set(original)


def test_partition_refuses_an_uneven_split():
    _, _, pcfg, pparams = _models(False, n_layers=3)
    with pytest.raises(ValueError, match="not divisible"):
        pt.partition_stages(pparams, pcfg, 2)


@pytest.mark.parametrize("num_stages", [2, 4])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_stage_chain_equals_the_fused_forward(moe, num_stages):
    _, _, pcfg, pparams = _models(moe)
    tokens = torch.from_numpy(_tokens((2, 24)))
    chained = _chain(pt.partition_stages(pparams, pcfg, num_stages), tokens, pcfg)
    fused = pt.forward(pparams, tokens, pcfg)
    assert chained.dtype == torch.float32 and chained.shape == fused.shape
    assert float((chained - fused).abs().max()) < CHAIN_TOL


@pytest.mark.parametrize("num_stages", [2, 4])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_stage_forward_matches_jax_per_stage(moe, num_stages):
    """Each stage on JAX's input to it: tokens for the first, the JAX
    chain's activations for the others."""
    jcfg, jparams, pcfg, pparams = _models(moe)
    tokens = _tokens((2, 24))
    jstages = jt.partition_stages(jparams, jcfg, num_stages)
    stages = pt.partition_stages(pparams, pcfg, num_stages)
    x = tokens
    for s, (tree, jtree) in enumerate(zip(stages, jstages)):
        first, last = s == 0, s == num_stages - 1
        ref = jt.stage_forward(jtree, jnp.asarray(x), jcfg, first=first, last=last)
        out = pt.stage_forward(tree, torch.from_numpy(np.array(x)), pcfg,
                               first=first, last=last)
        assert out.shape == ref.shape, s
        assert out.dtype == (torch.float32 if last else pcfg.dtype), s
        assert _err(out, ref) < STAGE_TOL, (s, _err(out, ref))
        x = np.asarray(ref)


def test_stage_chain_gradients_equal_the_fused_gradients():
    """Autograd through a 2-stage chain reaches the full tree's leaves (the
    stages' layers are views of them) with the fused forward's gradients."""
    _, _, pcfg, pparams = _models(True)
    tokens = torch.from_numpy(_tokens((2, 17)))
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(pparams)]

    def grads(logits):
        loss = pt.logits_loss(logits, tokens[:, 1:])
        return torch.autograd.grad(loss, leaves)

    chained = grads(_chain(pt.partition_stages(pparams, pcfg, 2), tokens[:, :-1], pcfg))
    fused = grads(pt.forward(pparams, tokens[:, :-1], pcfg))
    for a, b in zip(chained, fused):
        assert float((a - b).abs().max()) < CHAIN_TOL
