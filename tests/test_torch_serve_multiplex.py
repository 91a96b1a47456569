"""Model multiplexing on the port's serve plane (``ray_tpu_torch.serve``),
on the CPU.

Against the JAX package: seeded sequences of loads, hits, pins, unpins and
drains through the reference's ``ray_tpu.serve.multiplex.multiplexed``
and the port's, in plain asyncio, give equal event logs (loads,
checkpoint and unload calls, the evictions deferred); and tests/
test_serve.py's multiplexed deployment gives the same answers through
the reference's serve and the port's. Then the port alone: a replica's
evictions run checkpoint before unload in the order the reference's pure
LRU gives, a model id's requests stay on one of two replicas, a stream
pins its model until it ends, and a drain (an actor call to the replica)
checkpoints the loaded models. Serve runs on a runtime cluster the module
boots and shuts down; the deployments live in tests/_torch_serve_apps.py.
"""

import asyncio
import socket

import numpy as np
import pytest

import _torch_serve_apps as apps
import ray_tpu_torch as rt
from ray_tpu.serve import multiplex as ref_mux
from ray_tpu.serve._private import replica as ref_replica
from ray_tpu_torch import serve
from ray_tpu_torch.serve import long_poll
from ray_tpu_torch.serve import multiplex as port_mux
from ray_tpu_torch.serve import replica as port_replica


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


# ---------------------------------------------------------------- pure LRU
class _Model:
    """A model whose hooks log; its kind picks which hooks it has."""

    def __init__(self, model_id: str, kind: str, log: list):
        self.model_id, self.log = model_id, log
        if kind == "plain":
            self.checkpoint = lambda: log.append(("checkpoint", model_id))
            self.unload = lambda: log.append(("unload", model_id))
        elif kind == "serve_hooks":
            self.__serve_checkpoint__ = self._async_checkpoint
            self.__serve_unload__ = lambda: log.append(("serve_unload", model_id))
        elif kind == "failing_checkpoint":
            self.checkpoint = self._failing
            self.unload = lambda: log.append(("unload", model_id))

    async def _async_checkpoint(self):
        self.log.append(("serve_checkpoint", self.model_id))

    def _failing(self):
        self.log.append(("checkpoint_failed", self.model_id))
        raise RuntimeError("disk full")


def _script(seed: int) -> tuple[int, list]:
    """A seeded sequence of operations on two owners' caches."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(60):
        kind = rng.choice(["get", "get", "get", "pin", "unpin", "drain"])
        model = f"m{int(rng.integers(0, 6))}"
        ops.append((str(kind), int(rng.integers(0, 2)), model))
    return int(rng.integers(1, 4)), ops


async def _replay(mux, limit: int, ops: list) -> list:
    """The ops through ``mux``'s decorator; the event log, with the loaded
    models and the deferred evictions after each op."""
    log = []
    kinds = ["plain", "serve_hooks", "failing_checkpoint", "none"]

    class Owner:
        @mux.multiplexed(max_num_models_per_replica=limit)
        async def load(self, model_id):
            log.append(("load", model_id))
            return _Model(model_id, kinds[int(model_id[1:]) % len(kinds)], log)

    owners = [Owner(), Owner()]
    caches = mux._ALL_CACHES[-1]
    for kind, who, model in ops:
        if kind == "get":
            got = await owners[who].load(model)
            log.append(("got", who, got.model_id))
        elif kind == "pin":
            mux.pin_model(model)
        elif kind == "unpin":
            mux.unpin_model(model)
        else:
            log.append(("drained", await mux.checkpoint_loaded_models()))
        for _ in range(3):  # a deferred eviction runs as a task
            await asyncio.sleep(0)
        log.append(("state", [list(caches.get(id(o), {})) for o in owners],
                    [list(c) for c, _ in mux._DEFERRED], mux.pinned_models()))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_multiplex_event_logs_match_the_reference(seed, monkeypatch):
    limit, ops = _script(seed)
    logs = []
    for mux in (ref_mux, port_mux):
        monkeypatch.setattr(mux, "_PINS", {})
        monkeypatch.setattr(mux, "_DEFERRED", [])
        monkeypatch.setattr(mux, "_ALL_CACHES", [])
        logs.append(asyncio.run(_replay(mux, limit, ops)))
    assert logs[0] == logs[1]
    events = [e[0] for e in logs[1]]
    assert "load" in events and ("unload" in events or "serve_unload" in events)


def test_model_id_comes_from_the_request_metadata():
    for replica, mux in ((ref_replica, ref_mux), (port_replica, port_mux)):
        assert mux.get_multiplexed_model_id() == ""
        token = replica._request_context.set({"multiplexed_model_id": "m7"})
        try:
            assert mux.get_multiplexed_model_id() == "m7"
        finally:
            replica._request_context.reset(token)


# ------------------------------------------------------- the serve instances
@pytest.fixture(scope="module")
def port_serve():
    rt.init(num_cpus=16, _system_config={"rpc_retry_max_backoff_s": 0.05,
                                         "rpc_retry_max_attempts": 6})
    serve.start(http_port=_free_port())
    yield
    serve.shutdown()
    rt.shutdown()


@pytest.fixture(scope="module")
def mux(port_serve):
    return serve.run(apps.MultiModel.bind(), name="mux", route_prefix="/mux")


def test_multiplexed_answers_match_the_reference_serve(ray_start_shared, mux):
    """tests/test_serve.py's multiplexed deployment through both packages."""
    from ray_tpu import serve as ref

    @ref.deployment
    class MultiModel:
        def __init__(self):
            self.loads = []

        @ref.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id):
            self.loads.append(model_id)
            return {"id": model_id, "scale": int(model_id[-1])}

        async def __call__(self, x):
            model_id = ref.get_multiplexed_model_id() or "m1"
            model = await self.get_model(model_id)
            return x * model["scale"]

        def loaded(self, _):
            return list(self.loads)

    ref_handle = ref.run(MultiModel.bind(), name="refmux", route_prefix="/refmux")
    try:
        calls = [("m2", 10), ("m3", 10), ("m2", 5), ("", 4), ("m4", 3), ("m3", 2), ("m2", 1)]
        for handle in (ref_handle, mux):
            answers = [handle.options(multiplexed_model_id=m).remote(x).result(timeout=60)
                       for m, x in calls]
            assert answers == [20, 30, 10, 4, 12, 6, 2]
        # The same loads, in the same order: the LRU evicted alike.
        ref_loads = ref_handle.loaded.remote(0).result(timeout=60)
        port_loads = [e[1] for e in mux.events.remote(0).result() if e[0] == "load"]
        assert port_loads == ref_loads == ["m2", "m3", "m1", "m4", "m3", "m2"]
    finally:
        ref.shutdown()


def test_evictions_checkpoint_then_unload_as_the_lru_gives(port_serve):
    handle = serve.run(apps.MultiModel.bind(), name="mux_order", route_prefix="/mux_order")
    ids = [f"m{i}" for i in np.random.default_rng(9).integers(1, 6, 24)]
    for model_id in ids:
        assert handle.options(multiplexed_model_id=model_id).remote(2).result() == \
            2 * int(model_id[1])
    events = handle.events.remote(0).result()

    async def pure():
        log = []

        class Owner:
            @ref_mux.multiplexed(max_num_models_per_replica=2)
            async def load(self, model_id):
                log.append(("load", model_id))
                return apps.MuxModel(model_id, log)

        owner = Owner()
        for model_id in ids:
            await owner.load(model_id)
        return log

    assert events == asyncio.run(pure())
    for i, event in enumerate(events):
        if event[0] == "unload":
            assert events[i - 1] == ("checkpoint", event[1])
    assert sum(e[0] == "unload" for e in events) == sum(e[0] == "load" for e in events) - 2
    serve.delete("mux_order")


def test_a_model_ids_requests_stay_on_one_replica(port_serve):
    handle = serve.run(apps.MultiModelPair.bind(), name="mux_pair", route_prefix="/mux_pair")
    homes = {}
    for model_id in ("m1", "m2", "m3", "m4", "m5", "m6"):
        pids = {handle.options(multiplexed_model_id=model_id, method_name="pid")
                .remote(0).result() for _ in range(6)}
        assert len(pids) == 1, (model_id, pids)
        homes[model_id] = pids.pop()
    # The ring spreads the ids over both replicas.
    assert len(set(homes.values())) == 2
    serve.delete("mux_pair")


def test_a_stream_pins_its_model_until_it_ends(mux):
    streamer = mux.options(multiplexed_model_id="m5", method_name="stream")
    stream = streamer.remote(6).result()
    assert next(stream) == 0
    # Two more models while m5 streams: m5 is pinned, so the others go.
    assert mux.options(multiplexed_model_id="m6").remote(1).result() == 6
    assert mux.options(multiplexed_model_id="m7").remote(1).result() == 7
    during = mux.events.remote(0).result()
    assert ("unload", "m5") not in during
    assert list(stream) == [5, 10, 15, 20, 25]
    # m5 unpinned with two models loaded beside it: nothing over the bound.
    assert mux.options(multiplexed_model_id="m6").remote(1).result() == 6
    after = mux.events.remote(0).result()
    assert ("unload", "m5") in after[len(during):]
    assert after.index(("checkpoint", "m5")) == after.index(("unload", "m5")) - 1


def test_drain_checkpoints_the_loaded_models(mux):
    mux.options(multiplexed_model_id="m8").remote(1).result()
    mux.options(multiplexed_model_id="m9").remote(1).result()
    info = long_poll.get_subscriber().get_replicas("mux_MultiModel")
    (name,) = info["actor_names"]
    replica = rt.get_actor(name)
    reply = rt.get(replica.drain.remote(), timeout=30)
    assert reply["draining"] and reply["checkpointed_models"] == 2
    # A second drain checkpoints nothing more.
    again = rt.get(replica.drain.remote(), timeout=30)
    assert again["checkpointed_models"] == 0
