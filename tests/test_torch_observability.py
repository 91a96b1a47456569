"""Tracing and chaos at the port's wired call sites, against the JAX
package's where both can run here.

* collective spans join the comm flight records both ways on two gloo
  ranks, one span a user-visible op (the reference's
  ``tests/test_observability.py`` collective cases);
* a shm frame carrying a context is byte for byte the reference's frame;
* a traced compiled graph on the port's local actors (shm and device edges)
  chains the driver's context through every hop and stage span;
* the proxy's ``serve.request`` span parents the replica's span, from the
  ``X-RayTPU-Trace`` header or a caller's span, on a runtime cluster (the
  proxy and the replica are actors); ``serve.proxy.kill``, armed for a
  window of the schedule's clock (the proxy's process inherits the
  schedule from the cluster), drops a request and ends the proxy, which
  the controller restarts;
* the serve-LLM sampling decision is the reference's, and one sampled
  request's trace runs unbroken through prefill, the KV decode, the engine's
  iterations and its token events; the KV wire carries the context;
* a gang member's function runs under an ``execute`` span of the caller's
  trace, and the profiler's step marks carry the ambient ids into the
  merged trace's ``trace_ids``;
* the ``train.checkpoint.mid_save`` and ``train.storage.pre_commit`` kills
  leave torn saves that verification rejects and ``latest_checkpoint``
  skips (the reference's ``tests/test_checkpoint_commit.py``).
"""

import asyncio
import http.client
import json
import os
import socket
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from ray_tpu._private import config as ref_config
from ray_tpu._private import profile_merge as ref_merge
from ray_tpu._private import profiler as ref_profiler
from ray_tpu.dag import channel as ref_channel
from ray_tpu.serve.llm import observability as ref_obs
from ray_tpu.util import tracing as ref_tracing

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import config as port_config
from ray_tpu_torch._private import local_tasks
from ray_tpu_torch._private import profile_merge as port_merge
from ray_tpu_torch._private import profiler as port_profiler
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.dag import channel as port_channel
from ray_tpu_torch.dag.channels import ShmChannel
from ray_tpu_torch.serve.llm import observability as port_obs
from ray_tpu_torch.train import checkpoint as ckpt
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.chaos import ChaosFault, FaultSchedule, read_event_log
from ray_tpu_torch.util.collective import flight

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_dag_apps as dag_apps  # noqa: E402
import _torch_obs_apps as obs_apps  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402


@pytest.fixture
def session(tmp_path, monkeypatch):
    """Tracing on in this process (both packages) and in every process it
    starts from here, exporting under one session directory."""
    path = tmp_path / "session"
    path.mkdir()
    monkeypatch.setenv("RAY_TPU_tracing_enabled", "1")
    monkeypatch.setenv("RAYTPU_SESSION_DIR", str(path))
    for pkg_tracing, pkg_config in ((tracing, port_config), (ref_tracing, ref_config)):
        pkg_tracing.flush()
        monkeypatch.setattr(pkg_config.global_config(), "tracing_enabled", True)
        monkeypatch.setattr(pkg_tracing, "_dir", str(path / "tracing"))
    yield str(path)
    tracing.flush()
    ref_tracing.flush()


def _spans(session_dir, want, timeout=30.0, **match):
    """The session's spans once ``want(spans)`` holds (other processes
    flush every 0.2 s)."""
    deadline = time.monotonic() + timeout
    while True:
        spans = [s for s in tracing.read_spans(session_dir)
                 if all(s.get(k) == v for k, v in match.items())]
        if want(spans) or time.monotonic() > deadline:
            return spans
        time.sleep(0.1)


# ---------------------------------------------------------------- collectives
def test_collective_spans_join_flight_records_on_two_gloo_ranks(session, tmp_path):
    (tmp_path / "ranks").mkdir()
    results, _ = run_ranks(obs_apps.traced_collective_rank, 2, tmp_path / "ranks",
                           (session,), timeout_s=120.0)
    spans = [s for s in tracing.read_spans(session) if s["name"].startswith("collective.")]
    records = [r for recs, _ in results for r in recs]
    ring = [r for r in records if r["group"] == "obs_ring"]
    assert len(ring) == 2 * 4 and all(r["trace_id"] for r in ring)
    ring_spans = [s for s in spans if s["attributes"]["group"] == "obs_ring"]
    assert len(ring_spans) == len(ring)
    # Joined both ways: (trace id, comm_seq, comm_channel) of each span is a
    # record's, one for one.
    span_keys = sorted((s["trace_id"], s["attributes"]["comm_seq"],
                        s["attributes"]["comm_channel"]) for s in ring_spans)
    rec_keys = sorted((r["trace_id"], r["seq"], r["channel"]) for r in ring)
    assert span_keys == rec_keys
    assert {r["seq"] for r in ring if r["kind"] == "allreduce"} == {0, 1, 2}
    for s in ring_spans:
        attrs = s["attributes"]
        assert attrs["backend"] == "ring" and attrs["world_size"] == 2
        assert attrs["bytes"] == (64 if attrs["op"] == "allreduce" else 32)
        assert attrs["wire_bytes"] > 0
    # The spans' wire bytes are every byte the ring sent.
    for rank, (_, wire) in enumerate(results):
        mine = [s for s in ring_spans if s["attributes"]["rank"] == rank]
        assert sum(s["attributes"]["wire_bytes"] for s in mine) == wire["bytes_sent"]
    # The hier group records one span a rank, its tier none of its own.
    hier = [s for s in spans if s["attributes"]["group"].startswith("obs_hier")]
    assert sorted((s["attributes"]["group"], s["attributes"]["backend"],
                   s["attributes"]["bytes"]) for s in hier) == [("obs_hier", "hier", 4000)] * 2


# ---------------------------------------------------------------- compiled graphs
class _CaptureStore:
    pass


@pytest.mark.parametrize("ctx", [None, {"trace_id": "ab" * 16, "span_id": "cd" * 8}])
def test_a_shm_frame_is_byte_equal_to_the_references(ctx, monkeypatch):
    frames = {}
    for name, mod in (("ref", ref_channel), ("port", port_channel)):
        seen = []
        monkeypatch.setattr(mod, "try_write", lambda store, slot, parts, total, seen=seen:
                            seen.append((slot, b"".join(bytes(p) for p in parts), total)) or True)
        trace = ref_tracing.pack_ctx(ctx) if ctx else b""
        assert mod.try_write_seq(_CaptureStore(), "edge-3", 11, [b"payload", b"\x00" * 7], 14,
                                 epoch=2, trace=trace)
        frames[name] = seen
    assert frames["port"] == frames["ref"]
    (slot, frame, total), = frames["port"]
    assert total == len(frame) == 16 + 1 + (25 if ctx else 0) + 14


def test_a_shm_channel_carries_the_context_and_emits_its_hop(session, tmp_path):
    (tmp_path / "slots").mkdir()
    store = port_channel.SlotStore(str(tmp_path / "slots"))
    chan = ShmChannel(store, "edge", 4, group="obs")
    with tracing.span("ingress") as root:
        chan.push(0, {"x": 1})
    assert chan.pop(0) == {"x": 1}
    ctx = chan.last_trace
    assert ctx["trace_id"] == root.trace_id and ctx["sampled"]
    chan.push(1, "untraced")
    assert chan.pop(1) == "untraced" and chan.last_trace is None
    spans = {s["name"]: s for s in tracing.read_spans(session)}
    assert spans["channel.push"]["parent_id"] == root.span_id
    assert spans["channel.pop"]["parent_id"] == spans["channel.push"]["span_id"]
    notes = [r for r in flight.snapshot(512) if r["group"] == "obs"]
    assert [(r["kind"], r["trace_id"]) for r in notes[-4:]] == [
        ("chan_push", root.trace_id), ("chan_pop", root.trace_id),
        ("chan_push", None), ("chan_pop", None)]


@pytest.mark.parametrize("family", ["shm", "device"])
def test_a_traced_graph_chains_the_drivers_context(family, session):
    stage = local_tasks.remote(dag_apps.Stage)
    try:
        a, b = stage.remote(1), stage.remote(1)
        with InputNode() as inp:
            out = b.add.bind(a.add.bind(inp))
        dag = out.experimental_compile(channel=family)
        try:
            with tracing.span("dag.ingress") as root:
                assert dag.execute(40).get(timeout=60) == 42
            assert dag.execute(1).get(timeout=60) == 3  # untraced
        finally:
            dag.close()
    finally:
        local_tasks.shutdown()
    recs = [r for r in flight.snapshot(512)
            if r.get("site") == "dag" and r.get("trace_id") == root.trace_id]
    assert {"chan_push"} <= {r["kind"] for r in recs}

    def ready(spans):
        names = [s["name"] for s in spans]
        return names.count("dag.stage add") >= 2 and names.count("channel.pop") >= 3

    spans = _spans(session, ready, trace_id=root.trace_id)
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    stages = by_name["dag.stage add"]
    assert len(stages) == 2 and os.getpid() not in {s["pid"] for s in stages}
    assert len({s["pid"] for s in stages}) == 2
    pushes = {s["span_id"]: s for s in by_name["channel.push"]}
    assert len(pushes) == 3 and len(by_name["channel.pop"]) == 3
    assert all(p["parent_id"] in pushes for p in by_name["channel.pop"])
    assert {p["attributes"]["family"] for p in pushes.values()} == {family}
    # push (driver) -> pop -> stage -> push -> pop -> stage -> push -> pop (driver)
    stage_ids = {s["span_id"] for s in stages}
    assert sum(p["parent_id"] == root.span_id for p in pushes.values()) == 1
    assert sum(p["parent_id"] in stage_ids for p in pushes.values()) == 2
    # Only the traced execution made spans.
    assert len(tracing.read_spans(session)) == len(spans)


# ---------------------------------------------------------------- the serve plane
def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


# The proxy kill's window on the schedule's clock: after the cluster, the
# deployment and the traced requests are up, and short enough that the
# restarted proxy's first request falls after it.
KILL_WINDOW = {"start_s": 12.0, "duration_s": 3.0, "count": 1}


def test_proxy_to_replica_span_propagation_and_the_proxy_kill(session, monkeypatch):
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    import _torch_serve_apps as apps

    schedule = FaultSchedule(seed=0, fail_points={"serve.proxy.kill": KILL_WINDOW})
    monkeypatch.setenv("RAY_TPU_chaos", schedule.to_json())
    chaos.reset()
    port = _free_port()
    info = rt.init(num_cpus=8, _system_config={"rpc_retry_max_backoff_s": 0.05,
                                               "rpc_retry_max_attempts": 6})
    try:
        serve.start(http_port=port)
        handle = serve.run(apps.Echo.bind(), name="techo", route_prefix="/techo")
        trace_id, parent_span = "f" * 32, "a" * 16
        status, body = _post(port, "/techo", {"v": 1},
                             {"X-RayTPU-Trace": f"{trace_id}:{parent_span}"})
        assert status == 200 and json.loads(body) == {"echo": {"v": 1}}
        with tracing.span("client") as client:
            assert handle.remote({"v": 2}).result(timeout=60) == {"echo": {"v": 2}}
        assert schedule.epoch + KILL_WINDOW["start_s"] > time.time(), "set-up outlasted the wait"
        # The armed serve.proxy.kill drops the request it hits and ends the
        # proxy's process; the controller restarts the proxy on its port.
        time.sleep(schedule.epoch + KILL_WINDOW["start_s"] + 0.2 - time.time())
        with pytest.raises((ConnectionError, http.client.HTTPException)):
            _post(port, "/techo", {"v": 3})
        time.sleep(max(0.0, schedule.epoch + sum(KILL_WINDOW[k] for k in ("start_s",
                                                                            "duration_s"))
                       - time.time()))

        def served():
            try:
                return _post(port, "/techo", {"v": 4})[0] == 200
            except (ConnectionError, http.client.HTTPException):
                return False

        deadline = time.monotonic() + 60
        while not served():
            assert time.monotonic() < deadline, "the proxy was not restarted"
            time.sleep(0.2)
        restarts = [p["restarts"] for p in rt.get(serve.start(http_port=None)
                                                  .get_proxies.remote(), timeout=30)]
        assert restarts == [1]
    finally:
        serve.shutdown()
        rt.shutdown()
        chaos.reset()
    spans = _spans(info["session_dir"], lambda s: len([x for x in s if x["name"].startswith(
        "serve.replica")]) >= 2)
    req = [s for s in spans if s["name"] == "serve.request /techo"]
    assert [s["trace_id"] for s in req if s["parent_id"] == parent_span] == [trace_id]
    rep = [s for s in spans if s["name"] == "serve.replica techo_Echo"]
    from_http = next(s for s in rep if s["trace_id"] == trace_id)
    assert from_http["parent_id"] == next(s["span_id"] for s in req
                                          if s["trace_id"] == trace_id)
    assert from_http["pid"] != os.getpid()
    from_client = next(s for s in rep if s["trace_id"] == client.trace_id)
    assert from_client["parent_id"] == client.span_id


# ---------------------------------------------------------------- serve-LLM
def test_the_sampling_decision_is_the_references():
    for frac in (0.0, 0.05, 0.25, 0.5, 0.9, 1.0):
        ids = [f"req-{i}" for i in range(400)] + ["", "seqtrace1", "http-0-17"]
        assert [port_obs.sampled(r, frac) for r in ids] == [ref_obs.sampled(r, frac) for r in ids]


async def _traced_generate(decode, n):
    with tracing.span("serve.replica llm_decode") as root:
        out = await decode.generate({"prompt": "trace me", "max_tokens": n,
                                     "request_id": "seqtrace1"})
        stream = await decode.generate({"prompt": "stream trace", "max_tokens": 4,
                                        "stream": True, "request_id": "seqtrace2"})
        events = [e async for e in stream]
    decode._engine.stop()
    return root, out, events


def test_a_sampled_request_traces_through_the_engine(session, monkeypatch):
    from ray_tpu_torch.serve.llm import deployments as port_dep
    from ray_tpu_torch.util.timeline import build_sequence_trace

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    decode = port_dep.LLMDecode({"num_kv_blocks": 64, "max_slots": 4})
    root, out, events = asyncio.run(_traced_generate(decode, 5))
    toks = port_dep.tokenize("trace me")
    assert out["tokens"] == [port_dep._digest("", tuple(toks), i) % 32000 for i in range(5)]
    tokens = [e for e in events if "t" in e]
    assert [e["i"] for e in tokens] == [0, 1, 2, 3]
    assert {e["tr"] for e in tokens} == {root.trace_id}

    def ready(spans):
        return sum(s["name"] == "decode.iter" for s in spans) >= 5

    spans = _spans(session, ready, trace_id=root.trace_id)
    names = [s["name"] for s in spans]
    assert names.count("serve.prefill") == 2 and names.count("serve.kv_transfer") == 2
    # One iteration a token of the first sequence, then the stream's.
    assert names.count("decode.iter") == 5 + 4
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        if s["name"] in ("serve.prefill", "serve.kv_transfer", "decode.iter"):
            assert s["parent_id"] == root.span_id
    assert by_id[root.span_id]["name"] == "serve.replica llm_decode"
    port_obs.flush()
    records = [r for r in port_obs.read_sequences(session) if r.get("kind") == "seq"]
    assert {r["request_id"]: r["trace_id"] for r in records} == {
        "seqtrace1": root.trace_id, "seqtrace2": root.trace_id}
    tracing.flush()
    trace = build_sequence_trace(session, "seqtrace1")
    assert [e["name"] for e in trace["traceEvents"] if e.get("cat") == "token"] == [
        f"token[{i}]" for i in range(5)]
    json.dumps(trace)


def test_the_kv_wire_carries_the_context(session):
    from ray_tpu.serve.llm import wire as ref_wire

    from ray_tpu_torch.serve.llm import wire as port_wire

    class _Mailbox:
        def __init__(self):
            self.box = {}

        def send(self, payload, peer, tag):
            self.box[tag] = payload

        def recv(self, peer, tag, timeout):
            return self.box.pop(tag)

    assert port_wire._TR_WIRE == ref_wire._TR_WIRE
    group = _Mailbox()
    tx = port_wire.KVDeviceWire(group, peer=1, device="cpu")
    rx = port_wire.KVDeviceWire(group, peer=0, device="cpu")
    kv = np.arange(64, dtype=np.float32).reshape(4, 16)
    with tracing.span("serve.kv_transfer") as root:
        tx.push(0, kv)
    assert group.box["kvblk:p0:e0:1:0"][0] == "__tr"
    assert torch.equal(rx.pop(0), torch.from_numpy(kv))
    assert rx.last_trace["trace_id"] == root.trace_id
    tx.push(1, kv)
    assert group.box["kvblk:p0:e0:1:1"][0] == "__kv_exact"
    rx.pop(1)
    assert rx.last_trace is None
    spans = {s["name"]: s for s in tracing.read_spans(session)}
    assert spans["channel.push"]["parent_id"] == root.span_id
    assert spans["channel.pop"]["parent_id"] == spans["channel.push"]["span_id"]
    assert spans["channel.pop"]["attributes"]["family"] == "kv_wire"


# ---------------------------------------------------------------- gangs and the profiler
def test_a_gang_members_function_runs_under_an_execute_span(session):
    """On a cluster booted with tracing on: the member's ``execute
    <function>`` span is the caller's span's child (the runtime's own
    ``execute`` span of the actor call, which carries a ``task_id``, sits
    beside it)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.gang import WorkerGang

    info = rt.init(num_cpus=4)
    try:
        gang = WorkerGang(1, use_gpu=False)
        try:
            with tracing.span("driver") as root:
                (got,) = gang.run(obs_apps.ambient_trace, timeout=120)
            (untraced,) = gang.run(obs_apps.ambient_trace, timeout=120)
        finally:
            gang.shutdown()
    finally:
        rt.shutdown()
    assert got["inject"]["trace_id"] == root.trace_id
    spans = [s for s in _spans(info["session_dir"], lambda found: any(
        x["name"] == "execute ambient_trace" for x in found))
        if s["name"].startswith("execute ") and "task_id" not in s["attributes"]]
    assert [(s["name"], s["trace_id"], s["parent_id"], s["span_id"]) for s in spans
            if s["trace_id"] == root.trace_id] == [
        ("execute ambient_trace", root.trace_id, root.span_id, got["inject"]["span_id"])]
    # Without a caller's span the member starts a trace of its own.
    assert untraced["inject"]["trace_id"] != root.trace_id


def _marks(mod, pkg_tracing, tmp_path):
    plane = mod.ProfilePlane()
    plane.set_meta(rank=0, worker_id="w0")
    assert plane.arm({"capture_id": "c", "start_step": 2, "steps": 2, "max_s": 30,
                      "host": False, "device": False,
                      "session_dir": str(tmp_path)})["status"] == "ok"
    with pkg_tracing.span("execute loop") as root:
        for step in range(1, 6):
            plane.on_step_boundary(step)
    return root, plane.collect()


def test_profiler_step_marks_carry_the_ambient_ids(session, tmp_path):
    root, port = _marks(port_profiler, tracing, tmp_path / "port")
    ref_root, ref = _marks(ref_profiler, ref_tracing, tmp_path / "ref")
    assert [sorted(b) for b in port["boundaries"]] == [sorted(b) for b in ref["boundaries"]]
    assert {(b["trace_id"], b["span_id"]) for b in port["boundaries"]} == {
        (root.trace_id, root.span_id)}
    merged = port_merge.merge_captures([{**port, "rank": 0}], "c")
    assert merged["metadata"]["trace_ids"] == [root.trace_id]
    assert ref_merge.merge_captures([{**ref, "rank": 0}], "c")["metadata"]["trace_ids"] == [
        ref_root.trace_id]


# ---------------------------------------------------------------- checkpoints
def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4), "step": 7}


@pytest.fixture
def no_chaos(monkeypatch):
    for var in ("RAY_TPU_chaos", "RAY_TPU_chaos_log_dir"):
        monkeypatch.delenv(var, raising=False)
    chaos.reset()
    yield
    chaos.reset()


def test_a_mid_save_kill_leaves_a_save_verify_rejects(tmp_path, no_chaos):
    logs = tmp_path / "chaos"
    chaos.install(FaultSchedule(seed=0, fail_points={"train.checkpoint.mid_save": 1}),
                  identity="rank0", log_dir=str(logs), export_env=False)
    torn = tmp_path / "torn"
    with pytest.raises(ChaosFault):
        ckpt.save_pytree(str(torn), _tree())
    assert (torn / "shards" / "p0").is_dir()
    ok, reason = ckpt.verify_sharded_checkpoint(str(torn))
    assert not ok and "DONE.p0" in reason
    with pytest.raises(IOError):
        ckpt.load_pytree(str(torn))
    assert [(e["point"], e["method"], e["action"]) for e in read_event_log(str(logs))] == [
        ("failpoint", "train.checkpoint.mid_save", "fail")]
    # The budget is spent: the next save commits.
    ckpt.save_pytree(str(tmp_path / "whole"), _tree())
    assert ckpt.verify_sharded_checkpoint(str(tmp_path / "whole"))[0]
    # A torn save reported to the trainer's storage is refused, and the
    # committed one stays the latest.
    storage = ckpt.StorageContext(str(tmp_path / "store"), "exp")
    first = storage.persist(ckpt.Checkpoint(str(tmp_path / "whole")), {"step": 0})
    with pytest.raises(IOError, match="torn"):
        storage.persist(ckpt.Checkpoint(str(torn)), {"step": 1})
    assert storage.latest_checkpoint().path == first.path


def test_a_pre_commit_kill_is_reconciled_away(tmp_path, no_chaos):
    def saved(name):
        path = tmp_path / name
        ckpt.save_pytree(str(path), _tree())
        return ckpt.Checkpoint(str(path))

    storage = ckpt.StorageContext(str(tmp_path / "store"), "exp")
    first = storage.persist(saved("a"), {"step": 0})
    chaos.install(FaultSchedule(seed=0, fail_points={"train.storage.pre_commit": 1}),
                  export_env=False)
    with pytest.raises(ChaosFault):
        storage.persist(saved("b"), {"step": 1})
    chaos.reset()
    assert any(n.endswith(".staging") for n in os.listdir(storage.trial_dir))
    fresh = ckpt.StorageContext(str(tmp_path / "store"), "exp")
    assert not any(n.endswith(".staging") for n in os.listdir(fresh.trial_dir))
    assert fresh.latest_checkpoint().path == first.path


def test_the_fail_points_are_the_references_names():
    """Both packages arm their checkpoint kill windows by one name each, so
    one environment schedule kills either package's save."""
    import inspect

    from ray_tpu.train import checkpoint as ref_ckpt
    from ray_tpu.train._internal import storage as ref_storage

    for point, port_fn, ref_mod in (
            ("train.checkpoint.mid_save", ckpt.save_pytree, ref_ckpt),
            ("train.storage.pre_commit", ckpt.StorageContext.persist, ref_storage)):
        assert f'chaos.failpoint("{point}")' in inspect.getsource(port_fn)
        assert f'chaos.failpoint("{point}")' in inspect.getsource(ref_mod)
