"""The port's pipeline schedules and ``pipeline_apply`` against the JAX
package's.

  * The schedules are pure Python in both packages: ``schedule_1f1b``,
    ``schedule_interleaved_1f1b``, ``validate_schedule`` and
    ``bubble_fraction`` give equal results over a grid of (stages,
    microbatches, rank, virtual stages), and refuse the same inputs with
    the same errors.
  * ``check_message_order`` (the port's own) passes every schedule of the
    grid and refuses one that ``validate_schedule`` passes but whose sends
    on an edge come in another order than their receives.
  * ``pipeline_apply`` on four spawned gloo ranks {pp 4}, with
    ``tests/test_parallel.py``'s tanh stage function, against JAX's
    ``pipeline_apply`` on the conftest's CPU devices: the output at 1e-5
    (that test's bound) and the gradients of the weights and the input,
    summed over the ranks, at GRAD_F32_TOL against ``jax.grad`` of it.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from ray_tpu_torch.parallel import pipeline as port_pipe
from ray_tpu_torch.parallel.mesh import MeshSpec

WORLD = 4
PIPELINE_TOL = 1e-5
GRAD_F32_TOL = 2e-4
GRID = [(s, m, v) for s in (1, 2, 3, 4) for m in (1, 2, 3, 4, 6, 8) for v in (1, 2, 3)]


def _jax_pipe():
    from ray_tpu.parallel import pipeline as jax_pipe

    return jax_pipe


def _outcome(fn, *args):
    """fn's result, or the type and message of what it raised."""
    try:
        return ("ok", fn(*args))
    except (ValueError, TypeError) as err:
        return (type(err).__name__, str(err))


@pytest.mark.parametrize("stages,micro,virtual", GRID,
                         ids=[f"s{s}_m{m}_v{v}" for s, m, v in GRID])
def test_schedules_equal_jax(stages, micro, virtual):
    jax_pipe = _jax_pipe()
    for rank in range(-1, stages + 1):
        assert _outcome(port_pipe.schedule_interleaved_1f1b, stages, micro, rank, virtual) == \
            _outcome(jax_pipe.schedule_interleaved_1f1b, stages, micro, rank, virtual)
        assert _outcome(port_pipe.schedule_1f1b, stages, micro, rank) == \
            _outcome(jax_pipe.schedule_1f1b, stages, micro, rank)
    assert port_pipe.bubble_fraction(stages, micro, virtual) == \
        jax_pipe.bubble_fraction(stages, micro, virtual)
    try:
        scheds = [jax_pipe.schedule_interleaved_1f1b(stages, micro, r, virtual)
                  for r in range(stages)]
    except ValueError:
        return
    assert _outcome(port_pipe.validate_schedule, scheds, virtual) == \
        _outcome(jax_pipe.validate_schedule, scheds, virtual) == ("ok", None)
    port_pipe.check_message_order(scheds, virtual)


def _broken_schedules():
    """Op streams each package's validate_schedule refuses, one way each."""
    good = [port_pipe.schedule_1f1b(2, 2, r) for r in range(2)]
    return {
        "b_before_f": [[("B", 0), ("F", 0), ("F", 1), ("B", 1)], good[1]],
        "missing_backward": [[("F", 0), ("F", 1), ("B", 0)], [("F", 0), ("B", 0), ("F", 1)]],
        "deadlock": [[("F", 0), ("B", 0), ("F", 1), ("B", 1)],
                     [("F", 1), ("B", 1), ("F", 0), ("B", 0)]],
        "too_many_live": [[("F", 0), ("F", 1), ("F", 2), ("B", 0), ("B", 1), ("B", 2)],
                          port_pipe.schedule_1f1b(2, 3, 1)],
        "bad_chunk": [[("F", 0, 2), ("B", 0, 2)], good[1]],
        "unknown_op": [[("X", 0)], good[1]],
    }


@pytest.mark.parametrize("case", list(_broken_schedules()))
def test_validate_schedule_refuses_as_jax(case):
    jax_pipe = _jax_pipe()
    scheds = _broken_schedules()[case]
    port, ref = (_outcome(p.validate_schedule, scheds) for p in (port_pipe, jax_pipe))
    assert port == ref
    assert port[0] == "ValueError"


@pytest.mark.parametrize("args", [(0, 1, 1), (1, 0, 1), (1, 1, 0)])
def test_bubble_fraction_refuses_as_jax(args):
    port, ref = (_outcome(p.bubble_fraction, *args) for p in (port_pipe, _jax_pipe()))
    assert port == ref and port[0] == "ValueError"


def test_message_order_check_refuses_a_swapped_edge():
    # Rank 0 sends microbatch 1's activation before microbatch 0's; rank 1
    # receives 0 first. validate_schedule (a mailbox by tag) passes it; a
    # wire that pairs in posting order would hand rank 1 the wrong one.
    scheds = [[("F", 1), ("F", 0), ("B", 0), ("B", 1)],
              [("F", 0), ("B", 0), ("F", 1), ("B", 1)]]
    port_pipe.validate_schedule(scheds)
    _jax_pipe().validate_schedule(scheds)
    with pytest.raises(ValueError, match="edge 0->1: message 0 is sent as f1v1 but received "
                                         "as f0v1"):
        port_pipe.check_message_order(scheds)


def test_edge_messages_of_two_stage_interleaved():
    scheds = [port_pipe.schedule_interleaved_1f1b(2, 2, r, 2) for r in range(2)]
    sends, recvs = port_pipe.edge_messages(scheds, 2)
    assert sends == recvs
    # The wraparound: rank 1 hands chunk 0's output to rank 0's chunk 1.
    assert sends[(1, 0)][:2] == ["f0v2", "f1v2"]
    assert set(sends) == {(0, 1), (1, 0)}


# ------------------------------------------------------------ pipeline_apply
def _inputs():
    rng = np.random.default_rng(21)
    weights = (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((16, 16)).astype(np.float32)
    cot = rng.standard_normal((16, 16)).astype(np.float32)
    return weights, x, cot


def _stage_fn(stage_w, h):
    for w in stage_w.unbind(0):
        h = torch.tanh(h @ w)
    return h


def _rank(rank, weights, x, cot):
    mesh = MeshSpec({"pp": WORLD}).build("cpu")
    w = torch.from_numpy(weights).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_pipe.pipeline_apply(_stage_fn, w, xt, mesh=mesh, num_microbatches=4)
    (out * torch.from_numpy(cot)).sum().backward()
    with torch.no_grad():
        plain = port_pipe.pipeline_step(_stage_fn, w, xt, mesh=mesh, num_microbatches=4)
    return {"out": out.detach().numpy(), "step": plain.numpy(), "dw": w.grad.numpy(),
            "dx": xt.grad.numpy()}


def _jax_reference(weights, x, cot, devices):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import pipeline as jax_pipe
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec

    mesh = JaxMeshSpec({"pp": WORLD}).build(devices[:WORLD])

    def stage_fn(stage_w, h):
        def body(h, w):
            return jnp.tanh(h @ w), None
        out, _ = jax.lax.scan(body, h, stage_w)
        return out

    def apply(w, xx):
        return jax_pipe.pipeline_apply(stage_fn, w, xx, mesh=mesh, num_microbatches=4)

    out = jax.jit(apply)(weights, x)
    dw, dx = jax.jit(jax.grad(lambda w, xx: jnp.sum(apply(w, xx) * cot), argnums=(0, 1)))(
        weights, x)
    return {"out": np.asarray(out), "dw": np.asarray(dw), "dx": np.asarray(dx),
            "sequential": np.asarray(stage_fn(weights, x))}


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory, cpu_mesh_devices):
    weights, x, cot = _inputs()
    return run_ranks(_rank, WORLD, tmp_path_factory.mktemp("pipeline"), (weights, x, cot),
                     timeout_s=120, parent=lambda: _jax_reference(weights, x, cot,
                                                                  cpu_mesh_devices))


def test_pipeline_apply_matches_jax(pipeline_runs):
    ranks, ref = pipeline_runs
    for r in ranks:  # every rank holds the whole output
        np.testing.assert_allclose(r["out"], ref["out"], rtol=0, atol=PIPELINE_TOL)
        np.testing.assert_allclose(r["out"], ref["sequential"], rtol=0, atol=PIPELINE_TOL)
        np.testing.assert_array_equal(r["step"], r["out"])


def test_pipeline_apply_gradients_match_jax(pipeline_runs):
    ranks, ref = pipeline_runs
    # Each rank's weight gradient lands on its two layers, x's on rank 0.
    for rank, r in enumerate(ranks):
        mine = slice(2 * rank, 2 * rank + 2)
        others = np.delete(r["dw"], np.s_[mine], axis=0)
        assert not others.any()
        if rank:
            assert not r["dx"].any()
    dw = sum(r["dw"] for r in ranks)
    dx = sum(r["dx"] for r in ranks)
    np.testing.assert_allclose(dw, ref["dw"], rtol=0, atol=GRAD_F32_TOL)
    np.testing.assert_allclose(dx, ref["dx"], rtol=0, atol=GRAD_F32_TOL)


def test_pipeline_apply_refuses_an_uneven_batch():
    with pytest.raises(ValueError, match="not divisible by num_microbatches"):
        port_pipe.pipeline_apply(_stage_fn, torch.zeros(2, 4, 4), torch.zeros(5, 4),
                                 mesh=None, num_microbatches=2)
