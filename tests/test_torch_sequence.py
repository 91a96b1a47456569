"""Sequence parallelism of the port (ring and Ulysses attention) against the
JAX package's, across processes.

Four spawned gloo ranks (``_torch_ranks.run_ranks``) run the port's
``make_ring_attention`` and ``make_ulysses_attention``; the JAX package
runs its own on the conftest's virtual CPU devices meanwhile, from the same
inputs:

  * attention at ``tests/test_parallel.py``'s shapes (q, k, v of [2, 4,
    128, 16], sequence split over sp 4), causal and not: the output at
    F32_TOL and the gradients of q, k and v at GRAD_F32_TOL
    (``tests/test_ops.py``'s bounds) against ``jax.grad`` of the same;
  * ``TransformerConfig.tiny()`` with either attention over {dp 2, sp 2}:
    each rank holds one row of the batch and half of the sequence, with
    its global positions (``sequence_positions``), as
    ``tests/test_parallel.py::test_ring_attention_trains_in_model`` runs
    it; the logits at MODEL_LOGITS_TOL and the loss's gradients, summed
    over the ranks, at GRAD_F32_TOL against JAX's.

On CPU tensors each ring chunk runs the plain versions beside the flash
kernels (``_lse_reference``, ``_flash_backward_reference``): the same
merge and the same backward hops the card runs. On a machine with four
cards, ``test_sequence_parallel_on_four_cards`` runs the attention cases on
NCCL ranks, one a card, against ``flash_attention`` over the whole
sequence on the first card; elsewhere it skips.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel.mesh import MeshSpec, tree_leaves
from ray_tpu_torch.parallel.ring_attention import (
    make_ring_attention, make_ulysses_attention, sequence_positions,
)

WORLD = 4
F32_TOL = 2e-5
GRAD_F32_TOL = 2e-4
# tests/test_parallel.py holds ring attention in the model to 1e-3 against
# plain attention. Port against JAX, measured on the CPU: 5.5e-6 (ring) and
# 4.5e-6 (Ulysses), the f32 sums of two libraries through two layers.
MODEL_LOGITS_TOL = 2e-5
SHAPE = (2, 4, 128, 16)
KINDS = ("ring", "ulysses")
MAKERS = {"ring": make_ring_attention, "ulysses": make_ulysses_attention}


def _inputs():
    rng = np.random.default_rng(11)
    qkv = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3)]
    cot = rng.standard_normal(SHAPE).astype(np.float32)
    tokens = rng.integers(0, 256, (2, 65)).astype(np.int32)
    return qkv, cot, tokens


# ------------------------------------------------------------- rank side
def _attention_cases(rank, qkv, cot, device="cpu"):
    mesh = MeshSpec({"sp": WORLD}).build(device)
    seq = SHAPE[2] // WORLD
    cut = slice(rank * seq, (rank + 1) * seq)
    out = {}
    for kind in KINDS:
        attn = MAKERS[kind](mesh)
        for causal in (True, False):
            q, k, v = (torch.from_numpy(a[:, :, cut].copy()).to(device).requires_grad_(True)
                       for a in qkv)
            o = attn(q, k, v, causal)
            (o * torch.from_numpy(cot[:, :, cut].copy()).to(device)).sum().backward()
            out[(kind, causal)] = tuple(t.detach().cpu().numpy()
                                        for t in (o, q.grad, k.grad, v.grad))
    return out


def _model_cases(rank, init_tree, tokens):
    mesh = MeshSpec({"dp": 2, "sp": 2}).build("cpu")
    dp, sp = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    seq = (tokens.shape[1] - 1) // 2
    inputs = torch.from_numpy(tokens[dp:dp + 1, sp * seq:(sp + 1) * seq].copy())
    targets = torch.from_numpy(tokens[dp:dp + 1, sp * seq + 1:(sp + 1) * seq + 1].copy())
    positions = sequence_positions(mesh, 1, seq)
    out = {"coords": (dp, sp)}
    for kind in KINDS:
        config = pt.TransformerConfig.tiny(attention=MAKERS[kind](mesh))
        params = params_from_numpy(init_tree, device="cpu")
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        logits = pt.forward(params, inputs, config, positions)
        pt.logits_loss(logits, targets).backward()
        grads = {"/".join(path): leaf.grad.numpy() for path, leaf in tree_leaves(params)}
        out[kind] = (logits.detach().numpy(), grads)
    return out


def _rank(rank, qkv, cot, init_tree, tokens):
    return {"attention": _attention_cases(rank, qkv, cot), "model": _model_cases(rank, init_tree,
                                                                                 tokens)}


# ------------------------------------------------------------ parent side
def _jax_attention(qkv, cot, devices):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel.ring_attention import make_ring_attention as jring
    from ray_tpu.parallel.ring_attention import make_ulysses_attention as julysses

    mesh = JaxMeshSpec({"sp": WORLD}).build(devices[:WORLD])
    out = {}
    for kind, maker in (("ring", jring), ("ulysses", julysses)):
        attn = maker(mesh)
        for causal in (True, False):
            def loss(q, k, v, attn=attn, causal=causal):
                return jnp.sum(attn(q, k, v, causal) * cot)
            o = jax.jit(lambda q, k, v, attn=attn, causal=causal: attn(q, k, v, causal))(*qkv)
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*qkv)
            out[(kind, causal)] = tuple(np.asarray(t) for t in (o, *grads))
    return out


def _jax_model(tokens, devices):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel.ring_attention import make_ring_attention as jring
    from ray_tpu.parallel.ring_attention import make_ulysses_attention as julysses

    jax.config.update("jax_threefry_partitionable", True)
    mesh = JaxMeshSpec({"dp": 2, "sp": 2}).build(devices[:WORLD])
    params = jt.init_params(jt.TransformerConfig.tiny(attention="reference"),
                            jax.random.PRNGKey(0))
    sharding = NamedSharding(mesh, P("dp", "sp"))
    inputs = jax.device_put(tokens[:, :-1], sharding)
    targets = jax.device_put(tokens[:, 1:], sharding)
    out = {}
    for kind, maker in (("ring", jring), ("ulysses", julysses)):
        config = jt.TransformerConfig.tiny(attention=maker(mesh))
        logits = jax.jit(lambda p, t, config=config: jt.forward(p, t, config))(params, inputs)
        grads = jax.jit(jax.grad(lambda p, config=config: jt.loss_fn(p, inputs, targets,
                                                                     config)))(params)
        flat = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in
                jax.tree_util.tree_flatten_with_path(grads)[0]}
        out[kind] = (np.asarray(logits), flat)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_mesh_devices):
    import jax

    from ray_tpu.models import transformer as jt

    jax.config.update("jax_threefry_partitionable", True)
    init_tree = jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(
        jt.TransformerConfig.tiny(), jax.random.PRNGKey(0)))
    qkv, cot, tokens = _inputs()

    def reference():
        return _jax_attention(qkv, cot, cpu_mesh_devices), _jax_model(tokens, cpu_mesh_devices)

    ranks, (jax_attention, jax_model) = run_ranks(
        _rank, WORLD, tmp_path_factory.mktemp("sequence"), (qkv, cot, init_tree, tokens),
        timeout_s=180, parent=reference)
    return ranks, jax_attention, jax_model, init_tree


def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", KINDS)
def test_attention_forward_matches_jax(runs, kind, causal):
    ranks, jax_attention, _, _ = runs
    out = np.concatenate([r["attention"][(kind, causal)][0] for r in ranks], axis=2)
    assert out.shape == SHAPE and out.dtype == np.float32
    assert _max_err(out, jax_attention[(kind, causal)][0]) < F32_TOL


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", KINDS)
def test_attention_gradients_match_jax(runs, kind, causal):
    ranks, jax_attention, _, _ = runs
    for i, name in enumerate(("dq", "dk", "dv"), start=1):
        got = np.concatenate([r["attention"][(kind, causal)][i] for r in ranks], axis=2)
        assert _max_err(got, jax_attention[(kind, causal)][i]) < GRAD_F32_TOL, name


@pytest.mark.parametrize("kind", KINDS)
def test_model_logits_on_a_sequence_shard_match_jax(runs, kind):
    ranks, _, jax_model, _ = runs
    ref = jax_model[kind][0]
    seq = ref.shape[1] // 2
    for r in ranks:
        dp, sp = r["model"]["coords"]
        got = r["model"][kind][0]
        assert _max_err(got, ref[dp:dp + 1, sp * seq:(sp + 1) * seq]) < MODEL_LOGITS_TOL


@pytest.mark.parametrize("kind", KINDS)
def test_model_gradients_on_sequence_shards_match_jax(runs, kind):
    ranks, _, jax_model, _ = runs
    ref = jax_model[kind][1]
    # Each rank's loss is the mean over its quarter of the tokens: the
    # global mean's gradient is the ranks' mean.
    for name, want in ref.items():
        got = sum(r["model"][kind][1][name] for r in ranks) / WORLD
        assert _max_err(got, want) < GRAD_F32_TOL, name


def test_ulysses_refuses_heads_not_divisible_by_sp():
    from ray_tpu_torch.parallel import _wire
    from ray_tpu_torch.parallel.ring_attention import ulysses_attention

    class ThreeRanks(_wire.Wire):
        rank, size = 0, 3

    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="divisible by the sp axis"):
        ulysses_attention(q, q, q, ThreeRanks())


# ------------------------------------------------------------ four cards
def _card_rank(rank, qkv, cot):
    import torch.distributed as dist

    from ray_tpu_torch.ops.flash_attention import flash_attention

    torch.cuda.set_device(rank)
    cases = _attention_cases(rank, [a.astype(np.float32) for a in qkv], cot, device="cuda")
    whole = {}
    if rank == 0:
        for causal in (True, False):
            q, k, v = (torch.from_numpy(a).cuda().requires_grad_(True) for a in qkv)
            o = flash_attention(q, k, v, causal=causal)
            (o * torch.from_numpy(cot).cuda()).sum().backward()
            whole[causal] = tuple(t.detach().cpu().numpy() for t in (o, q.grad, k.grad, v.grad))
    dist.barrier()
    return {"attention": cases, "whole": whole}


@pytest.mark.cuda
def test_sequence_parallel_on_four_cards(tmp_path):
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards, found {torch.cuda.device_count()}")
    qkv, cot, _ = _inputs()
    ranks, _ = run_ranks(_card_rank, WORLD, tmp_path, (qkv, cot), timeout_s=300,
                         backend="nccl")
    whole = ranks[0]["whole"]
    for kind in KINDS:
        for causal in (True, False):
            for i in range(4):
                got = np.concatenate([r["attention"][(kind, causal)][i] for r in ranks], axis=2)
                tol = F32_TOL if i == 0 else GRAD_F32_TOL
                assert _max_err(got, whole[causal][i]) < tol, (kind, causal, i)
