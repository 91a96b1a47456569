"""The port's ``util/metrics.py`` against the reference's.

* The same sequence of Counter, Gauge and Histogram calls (tags, default
  tags, bucket bounds) and of the collective, serve and serve-LLM helpers
  leaves equal pending points in both packages: keys, kinds, names,
  descriptions, tags, values, counts, sums, buckets and bucket counts
  (the timestamps left out).
* On a cluster of each package, the same calls flushed to the controller's
  KV render the same exposition lines in ``collect_prometheus_text()``,
  with the reference's ``ray_tpu_`` names; the engine, control-plane and
  telemetry sections, whose values depend on the cluster, are compared by
  their series names.
* ``flush()`` sends one ``kv_multi_put`` a tick, whatever the number of
  series, and the values come back from the port controller's KV; a
  process with no runtime context drops its points at the flush.
"""

import json
import re
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu.util import metrics as ref_metrics
from ray_tpu_torch.util import metrics as port_metrics

PACKAGES = {"ref": ref_metrics, "port": port_metrics}
# Each package's flush, called by hand: the background flushers (a thread
# another test module of this process may have started) are stilled.
FLUSH = {name: mod.flush for name, mod in PACKAGES.items()}


@pytest.fixture(autouse=True)
def quiet_flushers(monkeypatch):
    """No background flush, and an empty pending table, in either package:
    the tests flush by hand (``FLUSH``)."""
    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "_ensure_flusher", lambda: None)
        monkeypatch.setattr(mod, "flush", lambda: None)
        with mod._local_lock:
            mod._pending.clear()
    yield
    for mod in PACKAGES.values():
        with mod._local_lock:
            mod._pending.clear()


def _record(mod) -> None:
    """One sequence of calls, the same in both packages."""
    requests = mod.Counter("app_requests_total", "Requests", tag_keys=("route",))
    requests.set_default_tags({"app": "demo"})
    for i in range(5):
        requests.inc(tags={"route": f"/r{i % 2}"})
    requests.inc(2.5, tags={"route": "/r0"})
    depth = mod.Gauge("app_queue_depth", "Queue depth")
    for value in (3, 7, 1):
        depth.set(value)
    latency = mod.Histogram("app_latency_s", "Latency", boundaries=(0.01, 0.1, 1.0),
                            tag_keys=("route",))
    for i, value in enumerate((0.005, 0.05, 0.5, 5.0, 0.01, 0.1)):
        latency.observe(value, tags={"route": f"/r{i % 2}"})
    mod.record_collective_op("allreduce", "ring", 4096, 0.002)
    mod.record_collective_op("allgather", "ring", 1 << 20, 0.03)
    mod.record_comm_stall("g0", "g0:allreduce:grad")
    mod.set_comm_inflight(2, 1.5, "rank0")
    for seconds, status in ((0.003, "200"), (0.04, "200"), (0.7, "500"), (0.0, "503")):
        mod.record_serve_request("app_Model", seconds, status)
    mod.inc_serve_reliability("retries", deployment="app_Model", reason="replica_death")
    mod.inc_serve_reliability("hedges", deployment="app_Model", outcome="launched")
    mod.inc_serve_reliability("shed", route="app_Model", where="proxy")
    mod.inc_serve_reliability("drains", deployment="app_Model", trigger="scale_down")
    mod.inc_serve_reliability("proxy_restarts", proxy="SERVE_PROXY::8000")
    mod.inc_serve_reliability("deadline_exceeded", deployment="app_Model")
    mod.inc_serve_reliability("stream_cancel_failures", deployment="app_Model")
    mod.set_serve_breaker_state("app_Model", "app_Model#a1", 2)
    for name, value in (("ongoing_requests", 4), ("queue_depth", 2), ("batch_occupancy", 0.75)):
        mod.set_serve_replica_gauge(name, "app_Model", "app_Model#a1", value)
    mod.record_serve_token_latency("ttft", 0.12, "llm_llm_decode")
    for seconds in (0.0008, 0.004, 0.02):
        mod.record_serve_token_latency("tpot", seconds, "llm_llm_decode")
    mod.inc_serve_tokens("issued", 48, "llm_llm_decode")
    mod.inc_serve_tokens("productive", 40, "llm_llm_decode")
    mod.inc_serve_tokens("replay_discarded", 0, "llm_llm_decode")
    mod.set_serve_kv_blocks("llm_llm_decode", "llm_llm_decode#b2", 12, 52)


def _pending(mod) -> dict:
    with mod._local_lock:
        return {key: {k: v for k, v in point.items() if k != "ts"}
                for key, point in mod._pending.items()}


def test_the_pending_points_are_the_references():
    for mod in PACKAGES.values():
        _record(mod)
    ours, theirs = _pending(port_metrics), _pending(ref_metrics)
    assert ours == theirs
    assert len(ours) == 33
    assert ours['app_requests_total{app="demo",route="/r0"}']["value"] == 5.5
    hist = ours['app_latency_s{route="/r0"}']
    assert hist["bucket_counts"] == [2, 0, 1, 0] and hist["count"] == 3


def test_a_flush_with_no_runtime_drops_the_points():
    assert not rt.is_initialized()
    _record(port_metrics)
    rpcs = port_metrics.flush_rpcs_total
    FLUSH["port"]()
    assert port_metrics.flush_rpcs_total == rpcs and _pending(port_metrics) == {}
    assert port_metrics.collect_prometheus_text() == ""


_SAMPLE = re.compile(r"^(\w+?)(_bucket|_count|_sum)?(\{.*\})? ")


def _series(name: str, labels: str) -> tuple:
    """A sample's series: its name and its labels, ``le`` left out."""
    tags = tuple(t for t in re.findall(r'(\w+="[^"]*")', labels or "")
                 if not t.startswith("le="))
    return name, tags


def _sections(text: str, recorded: set) -> tuple[list, set]:
    """The exposition's sample lines of the recorded series, in order (other
    processes of a cluster may record other series of the same names), and
    the names of every series outside them."""
    names = {name for name, _ in recorded}
    lines, others = [], set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            if line.split()[2] not in names:
                others.add(line.split()[2])
            continue
        match = _SAMPLE.match(line)
        if match is None or line.startswith("#"):
            continue
        name = match.group(1) if match.group(1) in names else match.group(1) + (
            match.group(2) or "")
        if _series(name, match.group(3)) in recorded:
            lines.append(line)
    return lines, others


@pytest.fixture(scope="module")
def clusters(ray_start_shared):
    rt.init(num_cpus=2)
    yield
    rt.shutdown()


def test_the_exposition_of_the_recorded_series_is_the_references(clusters):
    for name, mod in PACKAGES.items():
        _record(mod)
        FLUSH[name]()
    recorded = {_series("ray_tpu_" + point["name"],
                        ",".join(f'{k}="{v}"' for k, v in sorted(point["tags"].items())))
                for point in _recorded_points()}
    # The live sections fill in with each cluster's first heartbeats.
    deadline = time.monotonic() + 20
    while True:
        texts = {name: mod.collect_prometheus_text() for name, mod in PACKAGES.items()}
        ours, our_others = _sections(texts["port"], recorded)
        theirs, their_others = _sections(texts["ref"], recorded)
        if our_others == their_others or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    assert ours == theirs and len(ours) > 60
    assert 'ray_tpu_rt_serve_tpot_s_bucket{deployment="llm_llm_decode",le="0.001"} 1' in ours
    # The live sections, by their series names: the controller's counters
    # and gauges, each node's agent and native engine, its telemetry.
    assert our_others == their_others
    assert {"ray_tpu_controller_nodes_alive", "ray_tpu_oom_risk_events"} <= our_others


def _recorded_points() -> list:
    """The points one recording leaves, from a fresh pending table."""
    with port_metrics._local_lock:
        saved = dict(port_metrics._pending)
        port_metrics._pending.clear()
    _record(port_metrics)
    with port_metrics._local_lock:
        points = list(port_metrics._pending.values())
        port_metrics._pending.clear()
        port_metrics._pending.update(saved)
    return points


def test_a_flush_is_one_kv_multi_put_and_reads_back(clusters):
    from ray_tpu_torch._private import worker

    ctx = worker.get_global_context()
    _record(port_metrics)
    before = dict(ctx.controller.calls_by_method)
    rpcs = port_metrics.flush_rpcs_total
    FLUSH["port"]()
    after = dict(ctx.controller.calls_by_method)
    assert port_metrics.flush_rpcs_total == rpcs + 1
    assert {m: n - before.get(m, 0) for m, n in after.items() if n != before.get(m, 0)} == {
        "kv_multi_put": 1}
    FLUSH["port"]()  # nothing pending: no call
    assert ctx.controller.calls_by_method["kv_multi_put"] == after["kv_multi_put"]
    resp = ctx.io.run(ctx.controller.call(
        "kv_get", {"namespace": "metrics", "key": 'rt_serve_tokens_total{class="issued",'
                                                  'deployment="llm_llm_decode"}'}))
    point = json.loads(resp["value"])
    assert point["kind"] == "counter" and point["value"] >= 48
    text = port_metrics.collect_prometheus_text()
    assert re.search(r'^ray_tpu_rt_serve_kv_blocks_free\{deployment="llm_llm_decode",'
                     r'replica="llm_llm_decode#b2"\} 52\.0$', text, re.M)
