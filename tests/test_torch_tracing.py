"""The port's tracer (``ray_tpu_torch/util/tracing.py``) and the span half
of its timeline export (``ray_tpu_torch/util/timeline.py``) against the
JAX package's.

``pack_ctx`` bytes and ``unpack_ctx`` contexts are equal; a span file one
package writes is byte for byte the other's for the same spans, and each
package's ``read_spans`` reads the other's files; ``span``, ``begin`` /
``finish``, ``emit``, ``set_current`` and ``inject`` build the same trees;
the disabled path records nothing and writes no file; ``build_chrome_trace``
and ``build_sequence_trace`` give the same events from one session
(``build_sequence_trace`` on the synthetic session of the reference's
``tests/test_seq_observability.py``).
"""

import json
import os

import pytest
from ray_tpu._private import config as ref_config
from ray_tpu.util import timeline as ref_timeline
from ray_tpu.util import tracing as ref_tracing

from ray_tpu_torch._private import config as port_config
from ray_tpu_torch.util import timeline as port_timeline
from ray_tpu_torch.util import tracing as port_tracing

PACKAGES = {"ref": (ref_tracing, ref_config), "port": (port_tracing, port_config)}
TRACE_ID = "cd" * 16


@pytest.fixture
def traced(monkeypatch):
    """Tracing on in both packages, each exporting under a session
    directory the test sets with ``configure``; both restored after."""
    for tracing, config in PACKAGES.values():
        tracing.flush()
        monkeypatch.setattr(config.global_config(), "tracing_enabled", True)
        monkeypatch.setattr(tracing, "_dir", None)
    monkeypatch.delenv("RAYTPU_SESSION_DIR", raising=False)
    yield
    for tracing, _ in PACKAGES.values():
        tracing._buffer.clear()


@pytest.mark.parametrize("ctx", [
    {"trace_id": "0123456789abcdef" * 2, "span_id": "fedcba9876543210"},
    ("ab" * 16, "12" * 8),
    None,
    {"trace_id": "not-hex", "span_id": "00" * 8},
])
def test_pack_ctx_bytes_and_unpack_match_the_reference(ctx):
    packed = port_tracing.pack_ctx(ctx)
    assert packed == ref_tracing.pack_ctx(ctx)
    assert len(packed) in (0, port_tracing.CTX_WIRE_SIZE)
    assert port_tracing.unpack_ctx(packed) == ref_tracing.unpack_ctx(packed)
    assert port_tracing.unpack_ctx(packed[:10]) is None
    if packed:
        back = port_tracing.unpack_ctx(packed + b"trailing")
        trace_id = ctx["trace_id"] if isinstance(ctx, dict) else ctx[0]
        assert back == {"trace_id": trace_id, "span_id": back["span_id"], "sampled": True}


def _same_spans(pkg_tracing):
    """One Span object per case, the same values in either package."""
    span = pkg_tracing.Span
    return [
        span(name="serve.request /llm", trace_id=TRACE_ID, span_id="a" * 16,
             parent_id=None, start_ns=1_700_000_000_000_000_000,
             end_ns=1_700_000_000_050_000_000, attributes={"route": "llm_llm", "n": 3}),
        span(name='odd "name"\n', trace_id=TRACE_ID, span_id="b" * 16, parent_id="a" * 16,
             start_ns=5, end_ns=9, status="error",
             attributes={"error_type": "ValueError", "nested": {"x": [1, 2.5, None]}}),
    ]


def test_span_files_are_byte_equal_and_each_reads_the_others(traced, tmp_path):
    files = {}
    for name, (tracing, _) in PACKAGES.items():
        session = tmp_path / name
        tracing.configure(str(session))
        for rec in _same_spans(tracing):
            tracing._record(rec)
        tracing.flush()
        (path,) = list((session / "tracing").iterdir())
        assert path.name == f"spans-{os.getpid()}.jsonl"
        files[name] = path.read_bytes()
    assert files["port"] == files["ref"]
    # Each package reads the other's session.
    from_port = ref_tracing.read_spans(str(tmp_path / "port"))
    from_ref = port_tracing.read_spans(str(tmp_path / "ref"))
    assert from_port == from_ref and len(from_port) == 2
    assert from_port[1]["name"] == 'odd "name"\n'
    assert from_port[0]["pid"] == os.getpid()
    # to_json is the record a line holds.
    rec = _same_spans(port_tracing)[0]
    assert rec.to_json() == from_port[0]


def _shape(spans):
    """Spans with their ids replaced by ordinals (ids are random per
    process) and their times dropped."""
    order = {s["span_id"]: i for i, s in enumerate(spans)}
    traces = {}
    for s in spans:
        traces.setdefault(s["trace_id"], len(traces))
    return [(s["name"], traces[s["trace_id"]], order.get(s["parent_id"], s["parent_id"]),
             s["status"], s["attributes"]) for s in spans]


def _tree(tracing):
    """One sequence of calls through every way to make a span."""
    with tracing.span("root", kind="root") as root:
        assert tracing.inject() == tracing.context_of(root)
        with tracing.span("child") as child:
            tracing.emit("backdated", start_ns=10, end_ns=20, n=1)
            assert tracing.inject()["span_id"] == child.span_id
        hot = tracing.begin("hot", slots=4)
        token = tracing.set_current(hot)
        with tracing.span("under_hot"):
            pass
        tracing.reset_current(token)
        tracing.finish(hot)
        tracing.emit("explicit", parent=(root.trace_id, "f" * 16), start_ns=1)
        tracing.emit("from_dict", parent={"trace_id": TRACE_ID, "span_id": "e" * 16},
                     start_ns=1, end_ns=2, status="error")
        with pytest.raises(KeyError):
            with tracing.span("failing"):
                raise KeyError("x")
    assert tracing.inject() is None
    tracing.finish(tracing.begin("other_root"))
    tracing.flush()


def test_parentage_through_every_kind_of_span_matches_the_reference(traced, tmp_path):
    shapes = {}
    for name, (tracing, _) in PACKAGES.items():
        session = tmp_path / name
        tracing.configure(str(session))
        _tree(tracing)
        spans = tracing.read_spans(str(session))
        # Spans are recorded at their end: sort by start, then name.
        spans.sort(key=lambda s: (s["start_ns"] if s["name"] not in (
            "backdated", "explicit", "from_dict") else 0, s["name"]))
        shapes[name] = _shape(spans)
    assert shapes["port"] == shapes["ref"]
    names = [s[0] for s in shapes["port"]]
    assert set(names) == {"root", "child", "backdated", "hot", "under_hot", "explicit",
                          "from_dict", "failing", "other_root"}
    failing = next(s for s in shapes["port"] if s[0] == "failing")
    assert failing[3] == "error" and failing[4]["error_type"] == "KeyError"


def test_ids_have_the_references_shapes(traced, tmp_path):
    port_tracing.configure(str(tmp_path))
    with port_tracing.span("a") as a:
        pass
    assert len(a.trace_id) == 32 and len(a.span_id) == 16
    int(a.trace_id, 16), int(a.span_id, 16)
    b = port_tracing.begin("b")
    assert b.trace_id != a.trace_id and b.span_id != a.span_id
    packed = port_tracing.pack_ctx(port_tracing.context_of(b))
    assert ref_tracing.unpack_ctx(packed)["trace_id"] == b.trace_id


def test_the_disabled_path_records_nothing_and_writes_no_file(monkeypatch, tmp_path):
    monkeypatch.setattr(port_config.global_config(), "tracing_enabled", False)
    monkeypatch.setattr(port_tracing, "_dir", None)
    port_tracing.configure(str(tmp_path))
    with port_tracing.span("x") as span:
        assert span is None
        assert port_tracing.inject() is None
    assert port_tracing.emit("y", start_ns=1) is None
    port_tracing.flush()
    assert not (tmp_path / "tracing").exists()
    # Enabled but with no session directory: nothing is kept either.
    monkeypatch.setattr(port_config.global_config(), "tracing_enabled", True)
    monkeypatch.setattr(port_tracing, "_dir", None)
    monkeypatch.delenv("RAYTPU_SESSION_DIR", raising=False)
    with port_tracing.span("z"):
        pass
    assert not port_tracing._buffer


def test_the_session_directory_comes_from_the_environment(traced, tmp_path, monkeypatch):
    monkeypatch.setenv("RAYTPU_SESSION_DIR", str(tmp_path))
    with port_tracing.span("from_env"):
        pass
    assert [s["name"] for s in port_tracing.read_spans(str(tmp_path))] == ["from_env"]


def test_the_config_reads_the_environment_and_inherits_a_system_config(monkeypatch):
    import importlib
    import sys

    monkeypatch.setenv("RAY_TPU_tracing_enabled", "1")
    monkeypatch.setenv("RAY_TPU_testing_rpc_delay_ms", "9")
    monkeypatch.setenv("RAYTPU_SYSTEM_CONFIG", json.dumps(
        {"testing_rpc_delay_ms": 3, "object_store_memory": 1}))
    fresh = importlib.import_module("ray_tpu_torch._private.config")
    try:
        fresh = importlib.reload(fresh)
        cfg = fresh.global_config()
        assert cfg.tracing_enabled is True
        # The inherited dict wins over the environment; the reference
        # runtime's other knobs are not this config's.
        assert cfg.testing_rpc_delay_ms == 3
        assert not hasattr(cfg, "object_store_memory")
    finally:
        monkeypatch.delenv("RAY_TPU_tracing_enabled")
        monkeypatch.delenv("RAY_TPU_testing_rpc_delay_ms")
        monkeypatch.delenv("RAYTPU_SYSTEM_CONFIG")
        importlib.reload(sys.modules["ray_tpu_torch._private.config"])
    assert not port_config.global_config().tracing_enabled


def _write_session(root, spans, seq_records=()):
    tdir = root / "tracing"
    tdir.mkdir(parents=True)
    with open(tdir / "spans-1.jsonl", "w") as fh:
        for s in spans:
            fh.write(json.dumps(s) + "\n")
    if seq_records:
        with open(tdir / "sequences-1.jsonl", "w") as fh:
            for r in seq_records:
                fh.write(json.dumps(r) + "\n")


BASE_NS = 1_700_000_000 * 10**9
SYNTHETIC = [
    {"name": "serve.request /llm", "trace_id": TRACE_ID, "span_id": "a" * 16,
     "parent_id": None, "start_ns": BASE_NS, "end_ns": BASE_NS + 50_000_000,
     "status": "ok", "pid": 1, "attributes": {}},
    {"name": "decode.iter", "trace_id": TRACE_ID, "span_id": "b" * 16,
     "parent_id": "a" * 16, "start_ns": BASE_NS + 10_000_000,
     "end_ns": BASE_NS + 20_000_000, "status": "ok", "pid": 2, "attributes": {"slots": 1}},
    # A different trace must not leak into a sequence's view.
    {"name": "decode.iter", "trace_id": "ef" * 16, "span_id": "c" * 16, "parent_id": None,
     "start_ns": BASE_NS, "end_ns": BASE_NS + 1000, "status": "ok", "pid": 2,
     "attributes": {}},
    {"name": "execute loop", "trace_id": "12" * 16, "span_id": "d" * 16, "parent_id": None,
     "start_ns": BASE_NS, "end_ns": BASE_NS + 3000, "status": "error", "pid": 3,
     "attributes": {"worker_id": "w1"}},
]
SEQ_RECORD = {"kind": "seq", "ts": BASE_NS / 1e9 + 0.05, "request_id": "r1",
              "trace_id": TRACE_ID, "outcome": "productive", "cause": "completed",
              "tokens": 3, "replay_discarded": 0, "ttft_s": 0.012, "tpot_p50_s": 0.004,
              "tpot_p99_s": 0.008, "token_rel_s": [0.012, 0.016, 0.024]}


def test_build_chrome_trace_matches_the_reference(traced, tmp_path):
    _write_session(tmp_path, SYNTHETIC)
    port = port_timeline.build_chrome_trace(str(tmp_path))
    ref = ref_timeline.build_chrome_trace(str(tmp_path), include_counters=False)
    assert port == ref
    xs = [e for e in port["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 4 and all(e["args"]["trace_id"] for e in xs)
    tracks = {e["pid"]: e["args"]["name"] for e in port["traceEvents"] if e["ph"] == "M"}
    assert tracks[1] == "serve_proxy (pid 1)" and tracks[3] == "worker w1"
    json.dumps(port)
    # The controller's task events need the runtime's controller.
    with pytest.raises(NotImplementedError, match="14b"):
        port_timeline.build_chrome_trace(str(tmp_path), task_events=[{"state": "FINISHED"}])


def test_build_sequence_trace_from_the_synthetic_session_matches_the_reference(traced, tmp_path):
    _write_session(tmp_path, SYNTHETIC, [SEQ_RECORD])
    port = port_timeline.build_sequence_trace(str(tmp_path), "r1")
    assert port == ref_timeline.build_sequence_trace(str(tmp_path), "r1")
    events = port["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"serve.request /llm", "decode.iter"}
    req = next(e for e in xs if e["name"].startswith("serve.request"))
    it = next(e for e in xs if e["name"] == "decode.iter")
    assert it["args"]["parent_id"] == req["args"]["span_id"]
    assert req["ts"] <= it["ts"] <= req["ts"] + req["dur"]
    tokens = [e for e in events if e.get("cat") == "token"]
    assert len(tokens) == 3 and all(e["ph"] == "i" for e in tokens)
    ts = [e["ts"] for e in tokens]
    assert ts == sorted(ts) and ts[0] >= req["ts"]
    assert port["metadata"]["sequence"]["request_id"] == "r1"
    json.dumps(port)
    with pytest.raises(KeyError, match="seq_trace_sample"):
        port_timeline.build_sequence_trace(str(tmp_path), "nope")


def test_a_sequence_without_spans_anchors_on_its_record(traced, tmp_path):
    _write_session(tmp_path, [], [dict(SEQ_RECORD, trace_id="")])
    port = port_timeline.build_sequence_trace(str(tmp_path), "r1")
    assert port == ref_timeline.build_sequence_trace(str(tmp_path), "r1")
    assert [e["cat"] for e in port["traceEvents"]] == ["token"] * 3
