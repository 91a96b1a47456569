"""The port's compiled graphs (``ray_tpu_torch.dag``) against the
reference's (``ray_tpu.dag``) on the CPU.

The graphs are those of ``tests/test_dag.py``: interpreted, a linear
chain and repeated executes, a fan-in join, a multi-stage actor,
``MultiOutputNode``'s fan-out/fan-in order, error propagation,
``CHANNEL_DEPTH`` backpressure, constant arguments refused, and close()
with executions in flight. Both packages run each graph on the same
inputs at once: the reference's actors on a ``ray_start_shared`` cluster,
the port's on its local actor layer (``_private.local_tasks``), both from
the plain classes of ``tests/_torch_dag_apps.py``; their outputs, their
order and their errors' types must be equal. Every family runs in both:
shm, device (gloo here), socket and same-actor (local). The port's steady
state sends no message to any actor.

Then the slice end to end: a two-stage graph of CPU actors over
``TransformerConfig.tiny()`` (``_private.dag_apps.TransformerStage``, the
stage actor chip_smoke.py's phase 28 runs on the card) against the JAX
package's ``forward`` on the same parameters, f32 within FORWARD_TOL; and
the local actors' options: a GPU actor refused on a host without a card,
two actors at 0.5 of a declared card seeing card 0, a data worker seeing
none.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_dag_apps as apps
import ray_tpu
from ray_tpu import exceptions as ref_exceptions
from ray_tpu.dag import InputNode as RefInputNode
from ray_tpu.dag import MultiOutputNode as RefMultiOutputNode
from ray_tpu.dag.channels import LocalChannel as RefLocalChannel
from ray_tpu.models import transformer as jt
from ray_tpu_torch._private import dag_apps, local_tasks, resources
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.dag import channel as port_channel
from ray_tpu_torch.dag import channels as port_channels
from ray_tpu_torch.models import transformer as pt

# f32 through two layers in another order of sums: the bound
# tests/test_torch_stages.py holds one stage to against JAX's.
FORWARD_TOL = 2e-5

REF = {"Stage": ray_tpu.remote(apps.Stage), "InputNode": RefInputNode,
       "MultiOutputNode": RefMultiOutputNode, "get": ray_tpu.get,
       "TaskError": ref_exceptions.TaskError}
PORT = {"Stage": local_tasks.remote(apps.Stage), "InputNode": InputNode,
        "MultiOutputNode": MultiOutputNode, "get": local_tasks.get,
        "TaskError": local_tasks.TaskError}
SIDES = {"ref": REF, "port": PORT}


@pytest.fixture(scope="module", autouse=True)
def port_runtime():
    yield
    local_tasks.shutdown()


def _both(build):
    """``build(side)`` for the reference and the port."""
    return {name: build(side) for name, side in SIDES.items()}


def _chain(side, offsets=(1, 10, 100)):
    stages = [side["Stage"].remote(o) for o in offsets]
    with side["InputNode"]() as inp:
        node = inp
        for s in stages:
            node = s.add.bind(node)
    return node


def test_interpreted_dag(ray_start_shared):
    def run(side):
        a, b = side["Stage"].remote(1), side["Stage"].remote(10)
        with side["InputNode"]() as inp:
            out = b.add.bind(a.add.bind(inp))
        return out.execute(5)

    assert _both(run) == {"ref": 16, "port": 16}


def test_compiled_linear_chain_and_repeated_executes(ray_start_shared):
    def run(side):
        dag = _chain(side).experimental_compile()
        try:
            first = dag.execute(0).get(timeout=60)
            refs = [dag.execute(i) for i in range(5)]
            return [first] + [r.get(timeout=60) for r in refs]
        finally:
            dag.close()

    got = _both(run)
    assert got["port"] == got["ref"] == [111] + [111 + i for i in range(5)]


def test_compiled_fan_in_join(ray_start_shared):
    def run(side):
        a, b, j = (side["Stage"].remote(o) for o in (1, 2, 0))
        with side["InputNode"]() as inp:
            out = j.join.bind(a.add.bind(inp), b.add.bind(inp))
        dag = out.experimental_compile()
        try:
            return [dag.execute(v).get(timeout=60) for v in (10, 20)]
        finally:
            dag.close()

    got = _both(run)
    assert got["port"] == got["ref"] == [23, 43]


def test_compiled_multi_stage_actor(ray_start_shared):
    """One actor hosts two stages: the same-actor edge delivers in-process."""
    def run(side):
        a, b = side["Stage"].remote(1), side["Stage"].remote(10)
        with side["InputNode"]() as inp:
            out = b.add.bind(a.add.bind(a.add.bind(inp)))
        dag = out.experimental_compile()
        try:
            return [dag.execute(0).get(timeout=120), dag.execute(5).get(timeout=120)]
        finally:
            dag.close()

    got = _both(run)
    assert got["port"] == got["ref"] == [12, 17]


def test_multi_output_fan_out_fan_in_ordering(ray_start_shared):
    """Both leaves in declaration order; out-of-order get()s drain the
    channels without reordering seqs; the interpreted graph runs the shared
    upstream once."""
    def run(side):
        a, b, c = (side["Stage"].remote(o) for o in (1, 10, 100))
        with side["InputNode"]() as inp:
            h = a.add.bind(inp)
            out = side["MultiOutputNode"]([b.add.bind(h), c.add.bind(h)])
        interpreted = out.execute(0)
        dag = out.experimental_compile()
        try:
            first = dag.execute(0).get(timeout=60)
            refs = [dag.execute(i) for i in range(1, 5)]
            later = [refs[k].get(timeout=60) for k in (2, 0, 3, 1)]
            return interpreted, first, later
        finally:
            dag.close()

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"] == ([11, 101], [11, 101],
                           [[14, 104], [12, 102], [15, 105], [13, 103]])


def test_compiled_dag_error_propagates(ray_start_shared):
    def run(side):
        a, b = side["Stage"].remote(1), side["Stage"].remote(0)
        with side["InputNode"]() as inp:
            out = b.boom.bind(a.add.bind(inp))
        dag = out.experimental_compile()
        try:
            with pytest.raises(side["TaskError"], match="stage exploded"):
                dag.execute(1).get(timeout=60)
            # The graph stays usable after a stage raised.
            with pytest.raises(side["TaskError"], match="stage exploded"):
                dag.execute(2).get(timeout=60)
            return "raised"
        finally:
            dag.close()

    assert _both(run) == {"ref": "raised", "port": "raised"}


def test_execute_backpressure_at_ring_depth(ray_start_shared):
    """The (depth+1)-th un-popped execute is refused; draining reopens."""
    def run(side):
        a = side["Stage"].remote(1)
        with side["InputNode"]() as inp:
            out = a.add.bind(inp)
        dag = out.experimental_compile()
        try:
            depth = dag.CHANNEL_DEPTH
            refs = [dag.execute(i) for i in range(depth)]
            with pytest.raises(RuntimeError, match="in flight"):
                dag.execute(99)
            values = [r.get(timeout=60) for r in refs]
            return depth, values, dag.execute(0).get(timeout=60)
        finally:
            dag.close()

    got = _both(run)
    assert got["port"] == got["ref"] == (8, [i + 1 for i in range(8)], 1)


def test_constant_args_still_rejected(ray_start_shared):
    def run(side):
        a = side["Stage"].remote(1)
        with side["InputNode"]() as inp:
            out = a.join.bind(inp, 7)
        with pytest.raises(ValueError, match="constant"):
            out.experimental_compile()
        return "refused"

    assert _both(run) == {"ref": "refused", "port": "refused"}


def test_close_with_executions_in_flight_frees_every_slot(ray_start_shared):
    """close() drains what is in flight, frees every ring slot, refuses new
    work and is idempotent."""
    from ray_tpu._private.worker import get_global_context

    stores = {"ref": lambda: get_global_context().store.list(),
              "port": lambda: port_channel.local_store().list()}

    def run(name):
        side = SIDES[name]
        a = side["Stage"].remote(5)
        with side["InputNode"]() as inp:
            out = a.slow_add.bind(inp)
        dag = out.experimental_compile()
        dag.execute(np.ones(300_000, dtype=np.uint8)).get(timeout=60)  # a zero-copy slot
        refs = [dag.execute(i) for i in range(3)]
        del refs  # deliberately un-popped
        dag.close()
        with pytest.raises(RuntimeError, match="torn down"):
            dag.execute(9)
        dag.close()
        return [n for n in stores[name]() if n.startswith(f"dagch-{dag.dag_id}")]

    assert {name: run(name) for name in SIDES} == {"ref": [], "port": []}


@pytest.mark.parametrize("family", ["shm", "device", "socket"])
def test_each_family_gives_the_reference_outputs(ray_start_shared, family):
    """A chain on every edge of one family: scalars in flight at once, then
    a float32 array (zero-copy above 256 KiB on shm)."""
    arr = np.arange(100_000, dtype=np.float32)

    def run(side):
        dag = _chain(side).experimental_compile(channel=family)
        try:
            refs = [dag.execute(i) for i in range(4)]
            scalars = [r.get(timeout=120) for r in refs]
            return scalars, np.asarray(dag.execute(arr).get(timeout=120))
        finally:
            dag.close()

    got = _both(run)
    assert got["port"][0] == got["ref"][0] == [111, 112, 113, 114]
    np.testing.assert_array_equal(got["port"][1], got["ref"][1])
    np.testing.assert_array_equal(got["port"][1], arr + 111)


@pytest.mark.parametrize("family", ["shm", "device"])
def test_steady_state_sends_no_actor_message(ray_start_shared, family):
    """After compile an execute()/get() cycle sends no message to any
    actor (the port) and makes no controller call (the reference); the
    socket fallback sends a push and a pop a step."""
    from ray_tpu._private.worker import get_global_context

    def run(name):
        side = SIDES[name]
        a, b = side["Stage"].remote(1), side["Stage"].remote(2)
        with side["InputNode"]() as inp:
            out = b.add.bind(a.add.bind(inp))
        dag = out.experimental_compile(channel=family)
        count = (local_tasks.actor_messages if name == "port"
                 else lambda: get_global_context().controller.calls_total)
        try:
            dag.execute(0).get(timeout=60)  # warm every channel
            before = count()
            values = [dag.execute(i).get(timeout=60) for i in range(10)]
            return values, count() - before
        finally:
            dag.close()

    got = {name: run(name) for name in SIDES}
    assert got["port"] == got["ref"] == ([i + 3 for i in range(10)], 0)


def test_socket_steps_are_one_push_and_one_pop():
    a = PORT["Stage"].remote(1)
    with InputNode() as inp:
        out = a.add.bind(inp)
    dag = out.experimental_compile(channel="socket")
    try:
        dag.execute(0).get(timeout=60)
        before = local_tasks.actor_messages()
        assert [dag.execute(i).get(timeout=60) for i in range(5)] == [1, 2, 3, 4, 5]
        assert local_tasks.actor_messages() - before == 10
    finally:
        dag.close()


def test_placement_plan_pins_actors_and_ranks():
    """The driver is rank 0 and actors take 1..N in graph order; a dead
    actor fails the compile."""
    from ray_tpu_torch.dag.placement import PlacementError

    a, b = PORT["Stage"].remote(1), PORT["Stage"].remote(2)
    with InputNode() as inp:
        out = b.add.bind(a.add.bind(inp))
    dag = out.experimental_compile()
    try:
        plan = dag._plan
        assert (plan.rank_of(None), plan.rank_of(a._actor_id), plan.rank_of(b._actor_id),
                plan.world_size) == (0, 1, 2, 3)
        assert plan.colocated(a._actor_id, b._actor_id)
    finally:
        dag.close()
    local_tasks.kill(b)
    with InputNode() as inp:
        out = b.add.bind(a.add.bind(inp))
    with pytest.raises(PlacementError, match="no live placement"):
        out.experimental_compile()


def test_local_channel_batches_as_the_reference():
    """put, then one wait and a drain without waiting; [] on a timeout; a
    closed channel refuses puts (the port's with ChannelClosedError)."""
    import asyncio

    async def run(chan_cls):
        chan = chan_cls(maxsize=8, label="t")
        for i in range(5):
            await chan.put(i)
        first = await chan.pop_batch(3, 1.0)
        rest = await chan.pop_batch(8, 1.0)
        empty = await chan.pop_batch(8, 0.05)
        chan.close()
        try:
            await chan.put(9)
            refused = False
        except RuntimeError:
            refused = True
        return first, rest, empty, chan.qsize(), refused

    ref = asyncio.run(run(RefLocalChannel))
    port = asyncio.run(run(port_channels.LocalChannel))
    assert port == ref == ([0, 1, 2], [3, 4], [], 0, True)


def test_quantize_wire_is_refused_naming_the_item():
    """quantize_wire is ported (tests/test_torch_ring_trainer.py holds its
    codec); a kind the codec does not have is refused, naming the kinds, as
    the reference's CollectiveConfig refuses it."""
    a = PORT["Stage"].remote(1)
    with InputNode() as inp:
        out = a.add.bind(inp)
    with pytest.raises(ValueError, match="quantize_activations must be one of"):
        out.experimental_compile(quantize_wire="int4")


def test_a_cuda_payload_never_rides_the_host(monkeypatch):
    """A host channel refuses a CUDA tensor (pickling it would copy it
    through the host), and a device edge with no IPC or NCCL route for it
    raises. The card is stood in for by a marker subclass here."""
    class OnCard(torch.Tensor):
        pass

    card = torch.zeros(4).as_subclass(OnCard)
    monkeypatch.setattr(port_channel, "_is_cuda_tensor", lambda o: isinstance(o, OnCard))
    with pytest.raises(TypeError, match="cannot ride a host channel"):
        port_channel.serialize_parts({"x": card})
    monkeypatch.setattr(port_channels, "_is_cuda_tensor", lambda o: isinstance(o, OnCard))
    monkeypatch.setattr(port_channels, "_card_of", lambda group, t: "card-a")
    group = type("Group", (), {"cards": ["card-a"], "peer_cards": [["card-a"], ["card-b"]],
                               "nccl": None})()
    with pytest.raises(RuntimeError, match="not moved through the host"):
        port_channels.encode(group, 1, [card])


def _numpy_stages(jparams, n_stages: int) -> list:
    tree = jax.tree.map(np.asarray, jparams)
    per = len(tree["layers"]["wq"]) // n_stages
    stages = []
    for s in range(n_stages):
        stage = {"layers": {k: v[s * per:(s + 1) * per] for k, v in tree["layers"].items()}}
        if s == 0:
            stage["embed"] = tree["embed"]
        if s == n_stages - 1:
            stage["final_norm"] = tree["final_norm"]
            stage["lm_head"] = tree["lm_head"]
        stages.append(stage)
    return stages


@pytest.mark.parametrize("family", ["shm", "device"])
def test_two_stage_tiny_transformer_matches_jax_forward(family):
    """The slice end to end: InputNode -> stage0.forward -> stage1.forward
    on CPU actors holding the JAX package's tiny parameters, several
    executions in flight, each against ``forward`` at FORWARD_TOL."""
    jcfg = jt.TransformerConfig.tiny()
    pcfg = pt.TransformerConfig.tiny()
    config = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)}
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    stage_cls = local_tasks.remote(dag_apps.TransformerStage)
    actors = [stage_cls.remote(config, s, 2, tree=tree, device="cpu")
              for s, tree in enumerate(_numpy_stages(jparams, 2))]
    with InputNode() as inp:
        out = actors[1].forward.bind(actors[0].forward.bind(inp))
    dag = out.experimental_compile(channel=family)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32) for _ in range(3)]
    try:
        refs = [dag.execute(torch.from_numpy(b.astype(np.int64))) for b in batches]
        got = [r.get(timeout=120) for r in refs]
    finally:
        dag.close()
        for a in actors:
            local_tasks.kill(a)
    for tokens, logits in zip(batches, got):
        want = np.asarray(jt.forward(jparams, tokens, jcfg), np.float32)
        assert logits.shape == want.shape and logits.dtype == torch.float32
        assert float(np.max(np.abs(logits.numpy() - want))) < FORWARD_TOL


def test_gpu_actors_lease_cards_and_data_workers_see_none():
    """No card here: a GPU actor is refused, never run on the CPU. With one
    card declared, two actors at 0.5 share card 0; an actor that asked for
    no card and a data worker see none."""
    stage = PORT["Stage"]
    with pytest.raises(resources.InfeasibleResourcesError):
        stage.options(num_gpus=1).remote(0)
    try:
        resources.declare(num_gpus=1)
        halves = [stage.options(num_gpus=0.5).remote(0) for _ in range(2)]
        plain = stage.remote(0)
        assert local_tasks.get([h.env.remote() for h in halves], timeout=60) == ["0", "0"]
        assert resources.available_resources()["GPU"] == 0.0
        assert local_tasks.get(plain.env.remote(), timeout=60) == ""
        task = local_tasks.remote(apps.visible_devices)
        assert local_tasks.get(task.remote(0), timeout=60) == ""
        for h in halves:
            local_tasks.kill(h)
        assert resources.available_resources()["GPU"] == 1.0
    finally:
        resources.declare()
