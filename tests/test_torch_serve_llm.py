"""The serve-LLM engine (``ray_tpu_torch.serve.llm``) on the CPU.

Against the JAX package's ``ray_tpu.serve.llm``, in one process, the same
seeded inputs through both: the hash ring's picks, the slot table, the KV
block pool (block ids, free counts and pages bitwise after the same alloc,
write and release sequence), the toy model's tokens and KV, the KV wire's
encoded bytes (exact, int8, fp8) and ``wire_error``, the device wire's
epoch fencing on a mailbox group, the decode engine's token streams,
outcomes (completed, expired, shed) and pool use after eviction, and the
multiplexed models' pins. The pools here live in host memory
(``device="cpu"``).

Then one serve instance of the port, on a runtime cluster the module
boots and shuts down, runs ``build_llm_app`` end to end, with CPU replicas
(no GPU share, so each decode replica's pool is in host memory): HTTP and
handle tokens equal the digest, streaming, a fast 503 with Retry-After
when the pool is full, ``steady_rpc_probe`` at 0 on the runtime
controller client's counter, a shed
hedge that leaves its first attempt running, a shed request that moves to
a replica with room, a pool grown on its KV headroom while the prefill
pool stays, and a killed decode replica replayed exactly once.
"""

import asyncio
import concurrent.futures
import http.client
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.serve import multiplex as ref_mux
from ray_tpu.serve._private import routing as ref_routing
from ray_tpu.serve._private.common import Deadline as RefDeadline
from ray_tpu.serve.llm import batch as ref_batch
from ray_tpu.serve.llm import config as ref_config
from ray_tpu.serve.llm import deployments as ref_dep
from ray_tpu.serve.llm import engine as ref_engine
from ray_tpu.serve.llm import kv as ref_kv
from ray_tpu.serve.llm import observability as ref_obs
from ray_tpu.serve.llm import wire as ref_wire

import ray_tpu_torch as rt
import ray_tpu_torch.serve.llm as port_llm
from ray_tpu_torch import serve
from ray_tpu_torch._private import worker as port_worker
from ray_tpu_torch.serve import _common as port_common
from ray_tpu_torch.serve import long_poll
from ray_tpu_torch.serve import multiplex as port_mux
from ray_tpu_torch.serve import routing as port_routing
from ray_tpu_torch.serve.llm import batch as port_batch
from ray_tpu_torch.serve.llm import config as port_config
from ray_tpu_torch.serve.llm import deployments as port_dep
from ray_tpu_torch.serve.llm import engine as port_engine
from ray_tpu_torch.serve.llm import kv as port_kv
from ray_tpu_torch.serve.llm import observability as port_obs
from ray_tpu_torch.serve.llm import wire as port_wire

# wire_error is a mean of f32 differences: the two packages' means agree
# to f32 rounding.
WIRE_ERROR_TOL = 1e-7


@pytest.fixture(autouse=True)
def _clean_multiplex_pins():
    """Pin state is process-global in both packages: every test starts and
    ends clean."""
    for mux in (ref_mux, port_mux):
        mux._PINS.clear()
        mux._DEFERRED.clear()
    yield
    for mux in (ref_mux, port_mux):
        mux._PINS.clear()
        mux._DEFERRED.clear()


def _expected_tokens(prompt, n, model_id="", vocab=32000):
    toks = port_dep.tokenize(prompt)
    return [port_dep._digest(model_id, tuple(toks), i) % vocab for i in range(n)]


# ---------------------------------------------------------------- pure parts
def test_hash_ring_picks_spread_and_stability_match_the_reference():
    members = [f"replica-{i}" for i in range(5)]
    keys = [f"session-{i}" for i in range(600)]
    ref, port = ref_routing.HashRing(members), port_routing.HashRing(members)
    before = {k: port.pick(k) for k in keys}
    assert before == {k: ref.pick(k) for k in keys}
    counts = {m: sum(v == m for v in before.values()) for m in members}
    assert all(c > 40 for c in counts.values()), counts
    for ring in (ref, port):
        ring.update(members + ["replica-5"])
    after = {k: port.pick(k) for k in keys}
    assert after == {k: ref.pick(k) for k in keys}
    moved = [k for k in keys if after[k] != before[k]]
    assert moved and all(after[k] == "replica-5" for k in moved)
    assert len(moved) < len(keys) * 0.35
    for ring in (ref, port):
        ring.update(members[1:])
    assert all(port.pick(k) == before[k] for k in keys if before[k] != "replica-0")
    load = {"a": 7, "b": 5, "c": 9}
    for ring in (ref, port):
        ring.update(["a", "b", "c"])
    assert port.pick("hot", load=load, max_load=3) == ref.pick("hot", load=load, max_load=3)
    assert port.rank("hot") == ref.rank("hot")


@pytest.mark.parametrize("max_slots, buckets", [(8, (2, 4, 8)), (16, (32,)), (6, (4, 8, 2))])
def test_slot_batch_admit_evict_and_buckets_match_the_reference(max_slots, buckets):
    rng = np.random.default_rng(max_slots)
    ref, port = ref_batch.SlotBatch(max_slots, buckets), port_batch.SlotBatch(max_slots, buckets)
    assert port.buckets == ref.buckets
    for step in range(80):
        if rng.random() < 0.6 and port.free_count():
            seqs = [pkg.SequenceState(request_id=f"r{step}", prompt_tokens=[1], max_tokens=1)
                    for pkg in (ref_batch, port_batch)]
            assert port.admit(seqs[1]) == ref.admit(seqs[0])
        elif port.occupancy():
            idx = int(rng.choice([i for i, _ in port.active()]))
            assert port.evict(idx).request_id == ref.evict(idx).request_id
        assert [i for i, _ in port.active()] == [i for i, _ in ref.active()]
        assert (port.free_count(), port.occupancy()) == (ref.free_count(), ref.occupancy())
        n = port.occupancy()
        assert port.bucket_for(n) == ref.bucket_for(n)


@pytest.mark.parametrize("num_blocks, block_tokens, kv_dim", [(16, 4, 2), (64, 16, 16)])
def test_kv_block_pool_matches_the_reference_bitwise(num_blocks, block_tokens, kv_dim):
    rng = np.random.default_rng(num_blocks)
    ref = ref_kv.KVBlockPool(num_blocks, block_tokens, kv_dim)
    port = port_kv.KVBlockPool(num_blocks, block_tokens, kv_dim, device="cpu")
    live = []
    for _ in range(120):
        if rng.random() < 0.6 or not live:
            n_tokens = int(rng.integers(1, 5 * block_tokens))
            n = port.blocks_needed(n_tokens)
            assert n == ref.blocks_needed(n_tokens)
            ids = port.alloc(n)
            assert ids == ref.alloc(n)
            if ids is not None:
                kv = rng.standard_normal((n_tokens, kv_dim)).astype(np.float32)
                ref.write(ids, kv)
                port.write(ids, torch.from_numpy(kv))
                live.append(ids)
        else:
            ids = live.pop(int(rng.integers(len(live))))
            ref.release(ids)
            port.release(ids)
        assert (port.used(), port.free(), port.free_frac()) == (
            ref.used(), ref.free(), ref.free_frac())
        for ids in live:
            pages = port.read(ids)
            assert pages.device.type == "cpu" and pages.dtype == torch.float32
            np.testing.assert_array_equal(pages.numpy(), ref.read(ids))
    # Released blocks are scrubbed in both.
    everything = list(range(num_blocks))
    np.testing.assert_array_equal(port.read(everything).numpy(), ref.read(everything))


PROMPTS = ["the quick brown fox", "hello tpu", " ".join(f"w{i}" for i in range(40)), ""]


@pytest.mark.parametrize("model_id", ["", "lora-7"])
def test_toy_model_tokens_and_kv_match_the_reference(model_id):
    ref_cfg, port_cfg = ref_config.LLMConfig(), port_config.LLMConfig()
    assert port_cfg.to_dict() == ref_cfg.to_dict()
    for prompt in PROMPTS:
        toks = port_dep.tokenize(prompt)
        assert toks == ref_dep.tokenize(prompt)
        np.testing.assert_array_equal(port_dep.ToyLM(port_cfg).prefill(toks, model_id),
                                      ref_dep.ToyLM(ref_cfg).prefill(toks, model_id))
        seqs = [pkg.SequenceState(request_id=prompt, prompt_tokens=toks, max_tokens=4,
                                  model_id=model_id, generated=[1] * g)
                for pkg in (ref_batch, port_batch) for g in range(3)]
        # The synthetic decode compute runs as a torch product on the
        # port's device and changes no token.
        flops = {"decode_flops": 10_000}
        assert (port_dep.ToyLM(port_config.LLMConfig(**flops)).decode_step(
            seqs[3:], None, 4)
            == ref_dep.ToyLM(ref_config.LLMConfig(**flops)).decode_step(seqs[:3], None, 4))


@pytest.mark.parametrize("quantize, block", [(None, 64), ("int8", 64), ("int8", 32),
                                             ("fp8", 64)])
def test_kv_wire_bytes_and_error_match_the_reference(quantize, block):
    ref_cfg = ref_config.LLMConfig(kv_wire_quantize=quantize, kv_wire_block=block)
    port_cfg = port_config.LLMConfig(kv_wire_quantize=quantize, kv_wire_block=block)
    for prompt in PROMPTS:
        kv = ref_dep.ToyLM(ref_cfg).prefill(ref_dep.tokenize(prompt), "m1")
        ref_payload = ref_wire.encode_kv_blocks(kv, ref_cfg.wire_config())
        port_payload = port_wire.encode_kv_blocks(kv, port_cfg.wire_config())
        assert port_payload[:2] == ref_payload[:2]
        if quantize is None:
            assert port_payload[2].tobytes() == ref_payload[2].tobytes()
        else:
            ref_kind, ref_q, ref_scales, ref_n = ref_payload[2]
            kind, q, scales, n = port_payload[2]
            assert (kind, n) == (ref_kind, ref_n)
            assert q.tobytes() == ref_q.tobytes() and scales.tobytes() == ref_scales.tobytes()
        back = port_wire.decode_kv_blocks(port_payload)
        np.testing.assert_array_equal(back, ref_wire.decode_kv_blocks(ref_payload))
        on_device = port_wire.decode_kv_blocks(port_payload, "cpu")
        assert isinstance(on_device, torch.Tensor) and on_device.dtype == torch.float32
        np.testing.assert_array_equal(on_device.numpy(), back)
        err = port_wire.wire_error(kv, port_payload)
        assert abs(err - ref_wire.wire_error(kv, ref_payload)) <= WIRE_ERROR_TOL
        assert (err == 0.0) == (quantize is None)
    with pytest.raises(ValueError):
        port_wire.decode_kv_blocks(("__bogus", kv.shape, kv))


class _MailboxGroup:
    """A p2p group of tag-addressed one-shot mailboxes, as the collective
    transport's tagged send and recv pair messages."""

    def __init__(self):
        self.box = {}

    def send(self, payload, peer, *, tag):
        self.box[tag] = payload

    def recv(self, peer, *, tag, timeout=None):
        if tag not in self.box:
            raise TimeoutError(f"no frame for tag {tag!r}")
        return self.box.pop(tag)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_kv_device_wire_fences_epochs_as_the_reference(quantize):
    kv = ref_dep.ToyLM(ref_config.LLMConfig()).prefill(ref_dep.tokenize("fence me"), "")

    def run(pkg_wire, cfg, rx_kwargs):
        group = _MailboxGroup()
        tx = pkg_wire.KVDeviceWire(group, peer=1, src=0, dst=1, wire_cfg=cfg.wire_config(),
                                   **rx_kwargs)
        rx = pkg_wire.KVDeviceWire(group, peer=0, src=0, dst=1, **rx_kwargs)
        tx.push(7, kv)
        tags = [sorted(group.box)]
        got = [rx.pop(7)]
        tx.push(8, kv)
        rx.bump_epoch()
        with pytest.raises(TimeoutError):
            rx.pop(8, timeout=0.01)
        tx.bump_epoch()
        tx.push(8, kv * 2.0)
        got.append(rx.pop(8))
        tags.append(sorted(group.box))  # the fenced frame rots unread
        return tags, [np.asarray(g) for g in got]

    ref_tags, ref_got = run(ref_wire, ref_config.LLMConfig(kv_wire_quantize=quantize), {})
    port_tags, port_got = run(port_wire, port_config.LLMConfig(kv_wire_quantize=quantize),
                              {"device": "cpu"})
    assert port_tags == ref_tags == [["kvblk:p0:e0:1:7"], ["kvblk:p0:e0:1:8"]]
    for a, b in zip(port_got, ref_got):
        np.testing.assert_array_equal(a, b)


def test_observability_helpers_match_the_reference():
    for rid in (f"req-{i}" for i in range(200)):
        for frac in (0.0, 0.25, 0.5, 1.0):
            assert port_obs.sampled(rid, frac) == ref_obs.sampled(rid, frac)
    values = list(np.random.default_rng(0).random(37))
    for frac in (0.0, 0.5, 0.99, 1.0):
        assert port_obs.percentile(values, frac) == ref_obs.percentile(values, frac)
    ledgers = (ref_obs.TokenLedger(), port_obs.TokenLedger())
    for pkg, ledger in zip((ref_batch, port_batch), ledgers):
        ledger.issue(10)
        seq = pkg.SequenceState(request_id="r", prompt_tokens=[1], max_tokens=6,
                                generated=[1] * 6, resume_from=2)
        ledger.classify(seq, "productive")
        ledger.classify(pkg.SequenceState(request_id="s", prompt_tokens=[1], max_tokens=4,
                                          generated=[1] * 3), "evicted")
    assert ledgers[1].snapshot() == ledgers[0].snapshot()


# ---------------------------------------------------------------- the engine
class _Pkg:
    """One package's engine parts, for driving the same scenario."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.batch = port_batch if port else ref_batch
        self.config = port_config if port else ref_config
        self.dep = port_dep if port else ref_dep
        self.Deadline = port_common.Deadline if port else RefDeadline
        self.mux = port_mux if port else ref_mux

    def engine(self, cfg):
        model = self.dep.ToyLM(cfg)
        if self.name == "port":
            return port_engine.DecodeEngine(cfg, model, device="cpu"), model
        return ref_engine.DecodeEngine(cfg, model), model

    def seq(self, model, prompt, max_tokens, *, model_id="", deadline_s=None):
        toks = self.dep.tokenize(prompt)
        deadline = self.Deadline.after(deadline_s) if deadline_s else self.Deadline.never()
        return self.batch.SequenceState(request_id=prompt, prompt_tokens=toks,
                                        max_tokens=max_tokens, model_id=model_id,
                                        kv_data=model.prefill(toks, model_id),
                                        deadline=deadline)


async def _outcome(seq):
    try:
        return ("completed", (await seq.future)["tokens"])
    except Exception as exc:  # the outcome under test: an expiry or a shed
        return (type(exc).__name__, None)


async def _continuous(pkg):
    """Two waves, the second submitted mid-decode: it joins the running
    batch at the next iteration."""
    cfg = pkg.config.LLMConfig(max_slots=8, num_kv_blocks=128, slot_buckets=(4, 8))
    eng, model = pkg.engine(cfg)
    wave1 = [pkg.seq(model, f"w1-{i}", 12) for i in range(3)]
    for s in wave1:
        await eng.submit(s)
    while eng.iterations < 3:
        await asyncio.sleep(0.005)
    wave2 = [pkg.seq(model, f"w2-{i}", 12) for i in range(3)]
    for s in wave2:
        await eng.submit(s)
    out = [await _outcome(s) for s in wave1 + wave2]
    eng.stop()
    return out, eng


async def _deadline(pkg):
    cfg = pkg.config.LLMConfig(max_slots=4, num_kv_blocks=32)
    eng, model = pkg.engine(cfg)
    doomed = pkg.seq(model, "doomed", 10_000, deadline_s=0.05)
    fine = pkg.seq(model, "fine", 5)
    await eng.submit(doomed)
    await eng.submit(fine)
    out = [await _outcome(fine), await asyncio.wait_for(_outcome(doomed), 5.0)]
    eng.stop()
    return out, eng


async def _pool_pressure(pkg):
    """Four sequences of two blocks each on a four-block pool: two wait
    deferred for the first two to finish and free their pages."""
    cfg = pkg.config.LLMConfig(max_slots=8, num_kv_blocks=4, block_tokens=2, kv_dim=4)
    eng, model = pkg.engine(cfg)
    seqs = [pkg.seq(model, f"a{i} b{i} c{i} d{i}", 6) for i in range(4)]
    for s in seqs:
        await eng.submit(s)
    deferred = 0
    while eng.completed < 4:
        deferred = max(deferred, len(eng._deferred))
        await asyncio.sleep(0.001)
    out = [await _outcome(s) for s in seqs] + [("deferred_seen", deferred > 0)]
    eng.stop()
    return out, eng


async def _shed(pkg):
    cfg = pkg.config.LLMConfig(max_slots=2, num_kv_blocks=64, max_queued_seqs=2)
    eng, model = pkg.engine(cfg)
    for i in range(2):
        await eng.submit(pkg.seq(model, f"hog-{i}", 100_000))
    while eng.stats()["slot_occupancy"] < 2:
        await asyncio.sleep(0.005)
    for i in range(2):
        await eng.submit(pkg.seq(model, f"q-{i}", 100_000))
    t0 = time.monotonic()
    try:
        await eng.submit(pkg.seq(model, "straw", 4))
        out = [("admitted", None)]
    except Exception as exc:  # the shed under test
        out = [(type(exc).__name__, exc.retry_after_s > 0,
                f"retry_after_s={exc.retry_after_s:.3f}" in str(exc),
                time.monotonic() - t0 < 0.5)]
    eng.stop()
    return out, eng


async def _pinned(pkg):
    """A sequence of a multiplexed model pins it while it decodes."""
    cfg = pkg.config.LLMConfig(max_slots=4, num_kv_blocks=32)
    eng, model = pkg.engine(cfg)
    seq = pkg.seq(model, "pinned", 40, model_id="m1")
    await eng.submit(seq)
    while not eng.stats()["slot_occupancy"]:
        await asyncio.sleep(0.001)
    during = pkg.mux.pinned_models()
    out = [await _outcome(seq), ("pins_during", during), ("pins_after", pkg.mux.pinned_models())]
    eng.stop()
    return out, eng


@pytest.mark.parametrize("scenario", [_continuous, _deadline, _pool_pressure, _shed, _pinned],
                         ids=lambda f: f.__name__.strip("_"))
def test_decode_engine_matches_the_reference(scenario):
    results = {}
    for name in ("ref", "port"):
        out, eng = asyncio.run(scenario(_Pkg(name)))
        stats = eng.stats()
        results[name] = (out, {k: stats[k] for k in ("admitted", "completed", "shed",
                                                     "expired", "kv_blocks_used",
                                                     "kv_blocks_free")},
                         {k: stats["token_ledger"][k]
                          for k in ("productive", "shed", "replay_discarded", "seqs_shed")})
    assert results["port"] == results["ref"]
    for outcome in results["port"][0]:
        if outcome[0] == "completed":
            assert outcome[1] is not None


def test_a_replayed_stream_deduped_by_index_is_exactly_once():
    """A stream decoded again on a fresh engine (a new fence) gives the
    same tokens: a client that held 4 tokens of the first dedups the
    replay by index."""
    from ray_tpu_torch.dag.channels import LocalChannel

    cfg = port_config.LLMConfig(max_slots=4, num_kv_blocks=32)
    pkg = _Pkg("port")

    async def stream(eng, model):
        seq = pkg.seq(model, "replay me", 10)
        seq.out_chan = LocalChannel(maxsize=18, label="t-replay")
        await eng.submit(seq)
        events = []
        while True:
            got = await seq.out_chan.pop_batch(64, 2.0)
            assert got, "stream stalled"
            for ev in got:
                if ev.get("done"):
                    return events
                events.append(ev)

    async def main():
        (eng1, model), (eng2, _) = pkg.engine(cfg), pkg.engine(cfg)
        first, second = await stream(eng1, model), await stream(eng2, model)
        eng1.stop()
        eng2.stop()
        return eng1.fence, eng2.fence, first, second

    fence1, fence2, first, second = asyncio.run(main())
    assert fence1 != fence2
    seen = {}
    for ev in first[:4] + second:
        seen.setdefault(ev["i"], set()).add(ev["t"])
    assert sorted(seen) == list(range(10)) and all(len(v) == 1 for v in seen.values())
    assert [next(iter(seen[i])) for i in range(10)] == _expected_tokens("replay me", 10)


def test_multiplex_pins_defer_eviction_as_the_reference():
    def run(mux):
        events = []

        class Model:
            def __init__(self, mid):
                self.mid = mid

            def checkpoint(self):
                events.append(("checkpoint", self.mid))

            def unload(self):
                events.append(("unload", self.mid))

        class Host:
            @mux.multiplexed(max_num_models_per_replica=2)
            async def load(self, mid):
                return Model(mid)

        async def main():
            host = Host()
            await host.load("m1")
            await host.load("m2")
            mux.pin_model("m1")
            mux.pin_model("m2")
            await host.load("m3")
            log = [list(events), mux.pinned_models()]
            mux.unpin_model("m1")
            for _ in range(5):
                await asyncio.sleep(0)
            log.append(list(events))
            m2a, m2b = await host.load("m2"), await host.load("m2")
            mux.unpin_model("m2")
            for _ in range(5):
                await asyncio.sleep(0)
            return log + [m2a is m2b, list(events), mux.pinned_models()]

        return asyncio.run(main())

    port = run(port_mux)
    assert port == run(ref_mux)
    assert port[0] == [] and port[2] == [("checkpoint", "m1"), ("unload", "m1")]


def test_a_decode_replica_with_a_gpu_share_and_no_cuda_raises(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the GPU share is satisfied")
    with pytest.raises(RuntimeError, match="GPU share"):
        port_llm.LLMDecode({"num_kv_blocks": 8})
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    decode = port_llm.LLMDecode({"num_kv_blocks": 8})
    stats = decode.serve_llm_stats()
    assert stats["kv_device"] == "cpu"
    assert stats["kv_pool_bytes"] == 8 * 16 * 16 * 4


# ---------------------------------------------------------------- end to end
def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _post(port: int, path: str, body: dict, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _wait(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


SCALE_CONFIG = {"max_slots": 8, "slot_buckets": [8], "block_tokens": 2, "num_kv_blocks": 64,
                "decode_flops": 250_000}


@pytest.fixture(scope="module")
def llm_serve():
    """The port's serve with five apps, their replicas started at once:
    ``llm`` (one prefill, two decode replicas), ``llmfull`` (a decode pool
    of one slot and one queue seat), ``llmhedge`` (two decode replicas of one
    slot and no queue, hedging after 0.1 s), ``llmmove`` (the same without
    hedging) and ``llmscale``
    (release/benchmarks_serve_llm.py's tiny KV pool with kv_headroom_min 0.8
    on the decode pool only)."""
    port = _free_port()
    rt.init(num_cpus=32, _system_config={"rpc_retry_max_backoff_s": 0.05,
                                         "rpc_retry_max_attempts": 6})
    serve.start(http_port=port)
    scaling = {"min_replicas": 1, "max_replicas": 2, "target_ongoing_requests": 1000,
               "upscale_delay_s": 0.5, "downscale_delay_s": 600.0}
    apps = {
        "llm": (port_llm.build_llm_app({"max_slots": 16, "num_kv_blocks": 256},
                                       decode_replicas=2,
                                       decode_options={"health_check_period_s": 1.0}), "/llm"),
        "llmfull": (port_llm.build_llm_app(
            {"max_slots": 1, "max_queued_seqs": 1, "num_kv_blocks": 64},
            request_timeout_s=30.0), "/llmfull"),
        "llmhedge": (port_llm.build_llm_app(
            {"max_slots": 1, "max_queued_seqs": 0, "num_kv_blocks": 64}, decode_replicas=2,
            request_timeout_s=30.0,
            decode_options={"retry_policy": {"hedge": True, "hedge_after_s": 0.1}}),
            "/llmhedge"),
        "llmmove": (port_llm.build_llm_app(
            {"max_slots": 1, "max_queued_seqs": 0, "num_kv_blocks": 64}, decode_replicas=2,
            request_timeout_s=30.0), "/llmmove"),
        "llmscale": (port_llm.build_llm_app(
            SCALE_CONFIG, prefill_autoscaling=scaling,
            decode_autoscaling={**scaling, "kv_headroom_min": 0.8},
            request_timeout_s=120.0), "/llmscale"),
    }
    with concurrent.futures.ThreadPoolExecutor(len(apps)) as pool:
        futures = {name: pool.submit(serve.run, app, name=name, route_prefix=route)
                   for name, (app, route) in apps.items()}
        handles = {name: f.result() for name, f in futures.items()}
    yield port, handles
    serve.shutdown()
    rt.shutdown()


def _replica_metrics(qualified: str) -> list:
    return rt.get(serve.start(http_port=None).get_metrics.remote(), timeout=60)[qualified]


def test_app_tokens_over_handle_and_http_equal_the_digest(llm_serve):
    port, handles = llm_serve
    handle = handles["llm"]
    out = handle.options(method_name="generate").remote(
        {"prompt": "hello tpu", "max_tokens": 6}).result(timeout=60)
    assert out["tokens"] == _expected_tokens("hello tpu", 6)
    res = handle.options(method_name="generate_batch").remote(
        {"prompts": [f"p {i}" for i in range(8)], "max_tokens": 4}).result(timeout=60)
    assert [r["tokens"] for r in res["results"]] == [
        _expected_tokens(f"p {i}", 4) for i in range(8)]
    assert {r["fence"] for r in res["results"]} == {res["fence"]}
    alt = handle.options(method_name="generate").remote(
        {"prompt": "hello tpu", "max_tokens": 6, "model": "lora-7"}).result(timeout=60)
    assert alt["tokens"] == _expected_tokens("hello tpu", 6, model_id="lora-7") != out["tokens"]
    status, _, body = _post(port, "/llm", {"prompt": "warm cache line", "max_tokens": 4})
    assert status == 200, body
    assert json.loads(body)["tokens"] == _expected_tokens("warm cache line", 4)
    assert set(serve.status()["llm"]["deployments"]) == {"llm_prefill", "llm_decode"}
    # A keyless call takes a replica at random, so the four calls above can
    # all land on one. A session id pins its calls to one replica by hash:
    # calls under new ids reach the other, whose pool is then held too.
    for i in range(32):
        metrics = _replica_metrics("llm_llm_decode")
        if all(m["serve_llm"]["admitted"] for m in metrics):
            break
        spread = handle.options(method_name="generate", session_id=f"spread-{i}").remote(
            {"prompt": "hello tpu", "max_tokens": 6}).result(timeout=60)
        assert spread["tokens"] == out["tokens"]
    assert len(metrics) == 2
    for m in metrics:
        llm = m["serve_llm"]
        assert llm["kv_device"] == "cpu" and llm["kv_pool_bytes"] == 256 * 16 * 16 * 4
        assert llm["kv_blocks_used"] == 0 and 0 < llm["kv_wire_err"] < 0.02
    assert sum(m["serve_llm"]["completed"] for m in metrics) >= 11


def test_a_token_stream_through_the_handle(llm_serve):
    _, handles = llm_serve
    stream = handles["llm"].options(method_name="generate").remote(
        {"prompt": "stream these", "max_tokens": 9, "stream": True}).result(timeout=60)
    assert isinstance(stream, serve.ResponseStream)
    events = list(stream)
    assert [e["i"] for e in events] == list(range(9))
    assert [e["t"] for e in events] == _expected_tokens("stream these", 9)
    assert len({e["fence"] for e in events}) == 1


def test_steady_state_sends_no_call_to_the_controller(llm_serve):
    _, handles = llm_serve
    handle = handles["llm"].options(method_name="generate_batch", session_id="steady")
    load = handle.remote({"prompts": [f"load {i}" for i in range(16)], "max_tokens": 600})
    probe = handles["llm"].options(method_name="steady_rpc_probe",
                                   session_id="steady").remote().result(timeout=60)
    assert probe["best_window_iterations"] >= 100, probe
    assert probe["controller_rpcs"] == 0, probe
    assert len(load.result(timeout=120)["results"]) == 16


def test_a_full_pool_sheds_fast_with_retry_after_within_the_budget(llm_serve):
    """Two sequences that outlast their 5 s budget hold the only slot and the
    only queue seat; a request then sheds at once, over HTTP as a 503 whose
    Retry-After is capped by its own budget, and over the handle; at their
    deadline the engine evicts both and frees their pages."""
    port, _ = llm_serve
    decode = serve.get_deployment_handle("llm_decode", "llmfull")
    token = port_common.set_current_deadline(port_common.Deadline.after(5.0))
    try:
        hogs = [decode.options(method_name="generate").remote(
            {"prompt": f"hog {i}", "max_tokens": 10 ** 7}) for i in range(2)]
    finally:
        port_common.reset_current_deadline(token)
    stats = decode.options(method_name="serve_llm_stats")
    _wait(lambda: (lambda st: st["slot_occupancy"] >= 1 and st["queue_depth"] >= 1)(
        stats.remote().result(timeout=30)), 4, "the slot and the queue seat taken")
    budget = 3.0
    t0 = time.monotonic()
    status, headers, _ = _post(port, "/llmfull", {"prompt": "straw", "max_tokens": 4},
                               headers={"X-RayTPU-Deadline": str(budget)})
    assert status == 503
    assert time.monotonic() - t0 < 1.0
    assert 0.0 < float(headers["Retry-After"]) <= budget
    with pytest.raises(serve.RequestShedError):
        decode.options(method_name="generate").remote(
            {"prompt": "straw", "max_tokens": 4}).result(timeout=30)
    for hog in hogs:
        with pytest.raises(serve.DeadlineExceededError):
            hog.result(timeout=60)
    final = _wait(lambda: (lambda st: st if st["expired"] == 2 else None)(
        stats.remote().result(timeout=30)), 30, "both sequences evicted")
    assert final["kv_blocks_used"] == 0 and final["slot_occupancy"] == 0


def test_a_shed_hedge_leaves_the_first_attempt_running(llm_serve):
    """Two long sequences, one on each replica of one slot and no queue:
    each one's hedge goes to the other replica, which sheds it at once, and
    each first attempt still answers (the reference's handle would end both
    requests with the shed)."""
    keys = _keys_on_two_replicas("llmhedge_llm_decode")
    handle = serve.get_deployment_handle("llm_decode", "llmhedge").options(
        method_name="generate")
    calls = [handle.options(session_id=key).remote({"prompt": f"long {key}",
                                                    "max_tokens": 10_000})
             for key in keys]
    for key, call in zip(keys, calls):
        assert call.result(timeout=60)["tokens"] == _expected_tokens(f"long {key}", 10_000)
    reliability = handle._get_router().reliability()
    assert reliability["hedges_launched"] >= 1 and reliability["attempts_shed"] >= 1, reliability


def _keys_on_two_replicas(qualified):
    """Two session keys whose ring picks are the two replicas apart."""
    members = long_poll.get_subscriber().get_replicas(qualified)["actor_names"]
    ring = port_routing.HashRing(members)
    keys = [f"k{i}" for i in range(64)]
    return keys[0], next(k for k in keys if ring.pick(k) != ring.pick(keys[0]))


def test_a_shed_request_moves_to_a_replica_not_tried(llm_serve):
    """Two decode replicas of one slot and no queue, without hedging: a
    request that the busy replica sheds moves to the free one and answers;
    with both busy it is shed at once after trying each. The reference's
    handle ends the request at its first shed (ray_tpu/serve/handle.py,
    the RequestShedError branch of _await_result)."""
    key_a, key_b = _keys_on_two_replicas("llmmove_llm_decode")
    handle = serve.get_deployment_handle("llm_decode", "llmmove")
    generate = handle.options(method_name="generate")

    def occupied(key):
        st = handle.options(method_name="serve_llm_stats", session_id=key).remote().result(
            timeout=30)
        return st["slot_occupancy"] >= 1

    token = port_common.set_current_deadline(port_common.Deadline.after(6.0))
    try:
        hogs = [generate.options(session_id=key_a).remote(
            {"prompt": "hog a", "max_tokens": 10 ** 7})]
        _wait(lambda: occupied(key_a), 5, "the first replica's slot taken")
    finally:
        port_common.reset_current_deadline(token)
    out = generate.options(session_id=key_a).remote(
        {"prompt": "moved", "max_tokens": 5}).result(timeout=30)
    assert out["tokens"] == _expected_tokens("moved", 5)
    token = port_common.set_current_deadline(port_common.Deadline.after(5.0))
    try:
        hogs.append(generate.options(session_id=key_b).remote(
            {"prompt": "hog b", "max_tokens": 10 ** 7}))
        _wait(lambda: occupied(key_b), 5, "the second replica's slot taken")
    finally:
        port_common.reset_current_deadline(token)
    t0 = time.monotonic()
    with pytest.raises(serve.RequestShedError):
        generate.options(session_id=key_a).remote(
            {"prompt": "straw", "max_tokens": 5}).result(timeout=30)
    assert time.monotonic() - t0 < 1.0
    reliability = generate._get_router().reliability()
    assert reliability["attempts_shed"] >= 3 and reliability["shed_moves"] >= 2, reliability
    for hog in hogs:
        with pytest.raises(serve.DeadlineExceededError):
            hog.result(timeout=60)


class _ControllerClient:
    """Stands for the runtime's controller client: its per-method call
    counts, which the probe reads."""

    def __init__(self):
        self.calls_by_method: dict[str, int] = {}

    def call(self, method: str) -> None:
        self.calls_by_method[method] = self.calls_by_method.get(method, 0) + 1


def _fake_runtime(monkeypatch) -> _ControllerClient:
    client = _ControllerClient()
    monkeypatch.setattr(port_worker, "get_global_context",
                        lambda: type("Ctx", (), {"controller": client})())
    return client


def test_the_steady_probe_judges_whole_windows_only(monkeypatch):
    """A call to the controller every 40 decode iterations shows in every
    whole window of 100; the probe's last window, cut short by its timeout
    with no call in it, is listed and judged by none. The two background
    uplinks are subtracted by name."""
    client = _fake_runtime(monkeypatch)

    class _Engine:
        iterations = 0

    decode = port_dep.LLMDecode.__new__(port_dep.LLMDecode)
    decode._engine = _Engine()

    async def ticker():
        for i in range(230):
            decode._engine.iterations += 1
            if i % 40 == 39 and i < 200:
                client.call("get_actor_info")
            if i % 25 == 0:
                client.call("kv_multi_put")
                client.call("report_task_events")
            await asyncio.sleep(0.001)

    async def main():
        tick = asyncio.ensure_future(ticker())
        out = await decode.steady_rpc_probe({"iters": 100, "timeout_s": 1.5})
        await tick
        return out

    probe = asyncio.run(main())
    assert len(probe["window_iterations"]) == 3 and probe["window_iterations"][2] < 100, probe
    assert probe["best_window_iterations"] >= 100, probe
    assert probe["controller_rpcs"] >= 2 and set(probe["rpc_methods"]) == {"get_actor_info"}, probe


def test_the_steady_probe_stops_at_its_first_window_with_no_call(monkeypatch):
    """Only the background uplinks (the metrics flush and the task-event
    report) are sent: the first whole window reports 0 calls and ends the
    probe, as no later window could report fewer."""
    client = _fake_runtime(monkeypatch)

    class _Engine:
        iterations = 0

    decode = port_dep.LLMDecode.__new__(port_dep.LLMDecode)
    decode._engine = _Engine()
    stop = asyncio.Event()

    async def ticker():
        while not stop.is_set():
            decode._engine.iterations += 1
            if decode._engine.iterations % 30 == 0:
                client.call("kv_multi_put")
                client.call("report_task_events")
            await asyncio.sleep(0.001)

    async def main():
        tick = asyncio.ensure_future(ticker())
        out = await decode.steady_rpc_probe({"iters": 100, "timeout_s": 10.0, "windows": 3})
        stop.set()
        await tick
        return out

    probe = asyncio.run(main())
    assert len(probe["window_iterations"]) == 1 and probe["best_window_iterations"] >= 100, probe
    assert probe["controller_rpcs"] == 0 and probe["rpc_methods"] == {}, probe


def test_the_decode_pool_grows_on_kv_headroom_and_prefill_stays(llm_serve):
    """release/benchmarks_serve_llm.py's phase 3: 12-token prompts at 2
    tokens a block hold 6 of 64 blocks each; eight resident sequences leave
    a free fraction of 0.25, under the 0.8 floor."""
    def running(dep):
        return serve.status()["llmscale"]["deployments"][dep]["running_replicas"]

    stop, errors = threading.Event(), []
    prompt = " ".join(f"w{i}" for i in range(12))

    def loader(i):
        handle = serve.get_deployment_handle("llm_decode", "llmscale").options(
            method_name="generate")
        n = 0
        while not stop.is_set():
            try:
                out = handle.remote({"prompt": prompt, "max_tokens": 40,
                                     "request_id": f"scale-{i}-{n}"}).result(timeout=120)
                assert out["tokens"] == _expected_tokens(prompt, 40)
            except Exception as exc:  # reported below, with the thread's index
                if not stop.is_set():
                    errors.append(f"{i}: {type(exc).__name__}: {exc}")
                return
            n += 1

    threads = [threading.Thread(target=loader, args=(i,), daemon=True) for i in range(10)]
    for t in threads:
        t.start()
    try:
        prefill_moved = False

        def grown():
            nonlocal prefill_moved
            prefill_moved |= running("llm_prefill") > 1
            return running("llm_decode") >= 2

        _wait(grown, 60, "the decode pool's second replica")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert not prefill_moved and running("llm_prefill") == 1


def test_a_killed_decode_replica_is_replayed_exactly_once(llm_serve):
    """A stream's decode replica is SIGKILLed mid-stream: the client replays
    the request on the survivor (a new fence) and dedups by index; every
    token index arrives once, equal to the digest."""
    _, handles = llm_serve
    # By actor name, as the stream names its replica.
    pids = {f"SERVE_REPLICA::{m['replica_id']}": m["pid"]
            for m in _replica_metrics("llm_llm_decode")}
    assert len(pids) == 2
    n_tokens, seen, fences, killed = 300, {}, set(), None
    for _ in range(6):
        try:
            stream = handles["llm"].options(method_name="generate").remote(
                {"prompt": "sole survivor", "max_tokens": n_tokens, "stream": True,
                 "resume_from": len(seen)}).result(timeout=60)
            for ev in stream:
                fences.add(ev["fence"])
                seen.setdefault(ev["i"], set()).add(ev["t"])
                if killed is None:
                    killed = stream._replica
                    os.kill(pids[killed], signal.SIGKILL)
            break
        except (serve.ReplicaDiedError, RuntimeError):
            time.sleep(0.5)  # the stream's replica died: replay
    assert killed is not None and len(fences) == 2
    assert sorted(seen) == list(range(n_tokens))
    assert all(len(v) == 1 for v in seen.values())
    assert [next(iter(seen[i])) for i in range(n_tokens)] == _expected_tokens(
        "sole survivor", n_tokens)
    _wait(lambda: serve.status()["llm"]["deployments"]["llm_decode"]["running_replicas"] == 2
          and killed not in {f"SERVE_REPLICA::{m['replica_id']}"
                             for m in _replica_metrics("llm_llm_decode")},
          60, "the killed replica replaced")
