"""The serve plane's reliability and config on the port
(``ray_tpu_torch.serve``), on the CPU.

Against the JAX package: the circuit breaker's transitions over seeded
success and failure sequences under a stepped clock, ``RetryPolicy``,
the hedge's observed p95, the YAML schema's parse and overrides, and the
autoscaling decisions with a route p99 and a queue depth, over grids;
then, with the reference's serve booted for the module, a YAML deploy
(tests/test_serve.py's) and the gRPC proxy's replies and NOT_FOUND give
the same through both packages. Then the port alone: a hedge launched
after ``hedge_after_s`` on a slow replica wins on the other one and the
loser is cancelled; a replica that keeps failing opens its breaker and
leaves the routing until a probe closes it; the second proxy's actor,
killed, is restarted by the controller on its port; a route's p99 reaches
the controller and adds a replica above ``slo_p99_ms``; a replica asking
for custom resources the cluster holds none of free pends until they free
(the runtime's table, ``ray_tpu_torch.available_resources``); and the
hedge, route-p99 and resource options are taken. Serve runs on a runtime
cluster the module boots and shuts down.
"""

import dataclasses
import http.client
import json
import os
import signal
import socket
import time
import types

import numpy as np
import pytest

import _torch_serve_apps as apps
import ray_tpu_torch as rt
from ray_tpu.serve import handle as ref_handle_mod
from ray_tpu.serve import schema as ref_schema
from ray_tpu.serve._private import autoscaling_policy as ref_policy
from ray_tpu.serve._private.common import AutoscalingConfig as RefAutoscalingConfig
from ray_tpu.serve._private.common import RetryPolicy as RefRetryPolicy
from ray_tpu_torch import serve
from ray_tpu_torch.serve import autoscaling_policy, routing, schema
from ray_tpu_torch.serve import handle as port_handle_mod


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _http(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
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


# ---------------------------------------------------------------- pure parts
def _stepped_clock(monkeypatch, *modules):
    clock = types.SimpleNamespace(now=100.0)
    fake = types.SimpleNamespace(monotonic=lambda: clock.now)
    for module in modules:
        monkeypatch.setattr(module, "time", fake)
    return clock


def test_circuit_breaker_transitions_as_the_reference_test_has_them(monkeypatch):
    """tests/test_serve_reliability.py's sequence, on a stepped clock."""
    clock = _stepped_clock(monkeypatch, port_handle_mod)
    br = port_handle_mod.CircuitBreaker(failure_threshold=3, cooldown_s=0.2)
    CB = port_handle_mod.CircuitBreaker
    assert br.state == CB.CLOSED
    br.record_failure()
    br.record_failure()
    assert br.can_route()
    br.record_failure()
    assert br.state == CB.OPEN and not br.can_route()
    clock.now += 0.25
    assert br.can_route() and br.state == CB.HALF_OPEN
    br.record_failure()
    assert br.state == CB.OPEN and not br.can_route()
    clock.now += 0.25
    assert br.can_route()
    br.record_success()
    assert br.state == CB.CLOSED and br.can_route()


@pytest.mark.parametrize("seed", range(5))
def test_circuit_breaker_matches_the_reference(seed, monkeypatch):
    clock = _stepped_clock(monkeypatch, port_handle_mod, ref_handle_mod)
    rng = np.random.default_rng(seed)
    threshold, cooldown = int(rng.integers(1, 5)), float(rng.choice([0.1, 0.5, 2.0]))
    ours = port_handle_mod.CircuitBreaker(threshold, cooldown)
    ref = ref_handle_mod.CircuitBreaker(threshold, cooldown)
    states = set()
    for _ in range(300):
        clock.now += float(rng.choice([0.0, 0.05, 0.3, 1.0, 3.0]))
        op = str(rng.choice(["failure", "failure", "success", "route", "route"]))
        if op == "route":
            assert ours.can_route() == ref.can_route()
        else:
            getattr(ours, f"record_{op}")()
            getattr(ref, f"record_{op}")()
        assert ours.state == ref.state
        states.add(ours.state)
    assert states == {0, 1, 2}


def test_retry_policy_from_dict_matches_the_reference():
    raw = {"max_attempts": 5, "hedge": True, "from_the_future": 1}
    pol = serve.RetryPolicy.from_dict(raw)
    assert pol.max_attempts == 5 and pol.hedge is True and pol.hedge_after_s is None
    assert serve.RetryPolicy.from_dict({}).max_attempts == serve.RetryPolicy().max_attempts
    for d in (raw, {}, {"hedge_after_s": 0.05, "initial_backoff_s": 0.5},
              {"max_attempts": 8, "hedge": True, "retry_on_timeout": True}):
        assert (dataclasses.asdict(serve.RetryPolicy.from_dict(d))
                == dataclasses.asdict(RefRetryPolicy.from_dict(d)))


def test_observed_p95_matches_the_reference():
    rng = np.random.default_rng(5)
    ours = port_handle_mod.Router("D", "app")
    ref = ref_handle_mod.Router("D", "app")
    for n in range(200):
        assert ours.observed_p95() == ref.observed_p95()
        seconds = float(rng.lognormal(-4, 1))
        ours.note_latency(seconds)
        ref.note_latency(seconds)
    assert ours.observed_p95() != port_handle_mod.Router.DEFAULT_P95_S


YAML = """
http_options:
  host: 127.0.0.1
  port: {port}
  num_proxies: {num_proxies}
applications:
  - name: yamlapp
    route_prefix: /yaml
    import_path: {import_path}
    deployments:
      - name: Greeter
        num_replicas: 2
        user_config: {{greeting: "hola"}}
        retry_policy: {{max_attempts: 8, hedge: true}}
        ray_actor_options: {{num_gpus: 0.5}}
  - name: other
    import_path: pkg.mod:builder
    runtime_env: {{pip: [x]}}
"""


def test_yaml_schema_parses_as_the_reference(tmp_path):
    path = tmp_path / "serve.yaml"
    path.write_text(YAML.format(port=8163, num_proxies=2, import_path="a.b:app"))
    ours, ref = schema.ServeDeploySchema.from_yaml(str(path)), \
        ref_schema.ServeDeploySchema.from_yaml(str(path))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ([d.overrides() for a in ours.applications for d in a.deployments]
            == [d.overrides() for a in ref.applications for d in a.deployments])
    assert ours.applications[1].route_prefix == "/" and ours.http_options.num_proxies == 2
    for bad in ({}, {"applications": []}):
        with pytest.raises(ValueError, match="no applications"):
            schema.ServeDeploySchema.from_dict(bad)
        with pytest.raises(ValueError, match="no applications"):
            ref_schema.ServeDeploySchema.from_dict(bad)
    (tmp_path / "list.yaml").write_text("- a\n")
    with pytest.raises(ValueError, match="mapping"):
        schema.ServeDeploySchema.from_yaml(str(tmp_path / "list.yaml"))
    with pytest.raises(ValueError, match="module:attribute"):
        schema._import_target("no_colon")


SLO_CONFIGS = [
    dict(min_replicas=1, max_replicas=4, target_ongoing_requests=2.0, slo_p99_ms=50.0),
    dict(min_replicas=0, max_replicas=3, target_ongoing_requests=8.0, queue_weight=0.5,
         slo_p99_ms=200.0),
    dict(min_replicas=2, max_replicas=2, target_ongoing_requests=1.0, slo_p99_ms=10.0),
    dict(min_replicas=1, max_replicas=6, target_ongoing_requests=4.0,
         upscale_smoothing_factor=0.5),
]


@pytest.mark.parametrize("kwargs", SLO_CONFIGS, ids=lambda k: str(sorted(k.items())))
def test_decisions_with_p99_match_the_reference(kwargs):
    ours, ref = serve.AutoscalingConfig(**kwargs), RefAutoscalingConfig(**kwargs)
    for load in (0.0, 1.0, 6.0, 40.0):
        for current in (0, 1, 2, 5):
            for queue in (0.0, 4.0, 30.0):
                for p99 in (None, 5.0, 49.0, 51.0, 150.0, 1000.0):
                    got = autoscaling_policy.calculate_desired_num_replicas(
                        ours, load, current, queue_depth=queue, p99_ms=p99)
                    want = ref_policy.calculate_desired_num_replicas(
                        ref, load, current, queue_depth=queue, p99_ms=p99)
                    assert got == want, (load, current, queue, p99)
    rng = np.random.default_rng(8)
    delays = dict(upscale_delay_s=1.0, downscale_delay_s=3.0)
    ours_state = autoscaling_policy.AutoscalingState(serve.AutoscalingConfig(**kwargs, **delays))
    ref_state = ref_policy.AutoscalingState(RefAutoscalingConfig(**kwargs, **delays))
    now, current = 0.0, max(1, kwargs["min_replicas"])
    for _ in range(300):
        now += float(rng.choice([0.1, 0.5, 1.5]))
        load, queue = float(rng.choice([0, 2, 9, 30])), float(rng.choice([0, 0, 5]))
        p99 = [None, 20.0, 80.0, 400.0][int(rng.integers(0, 4))]
        got = ours_state.decide(load, current, now=now, queue_depth=queue, p99_ms=p99)
        assert got == ref_state.decide(load, current, now=now, queue_depth=queue, p99_ms=p99)
        current = got


# ------------------------------------------------------- the serve instances
@pytest.fixture(scope="module")
def port_serve():
    port = _free_port()
    while True:  # the second proxy takes the next port
        with socket.socket() as probe:
            try:
                probe.bind(("127.0.0.1", port + 1))
                break
            except OSError:
                port = _free_port()
    # One accelerator slot and one TPU, for the pending replica below.
    rt.init(num_cpus=32, resources={"accelerator_slot": 1, "TPU": 1},
            _system_config={"rpc_retry_max_backoff_s": 0.05, "rpc_retry_max_attempts": 6})
    serve.start(http_port=port, num_proxies=2)
    yield port
    serve.shutdown()
    rt.shutdown()


def _controller(method: str, *args):
    """The serve controller actor's ``method``, waited for."""
    return rt.get(getattr(serve.start(http_port=None), method).remote(*args), timeout=60)


def test_yaml_deploy_matches_the_reference_serve(ray_start_shared, port_serve, tmp_path):
    """tests/test_serve.py's YAML deploy through both packages."""
    from ray_tpu import serve as ref

    config = """
http_options:
  host: 127.0.0.1
  port: {port}
  num_proxies: {num_proxies}
applications:
  - name: yamlapp
    route_prefix: /yaml
    import_path: {import_path}
    deployments:
      - name: Greeter
        num_replicas: 2
        user_config: {{greeting: "hola"}}
"""
    ref_path, port_path = tmp_path / "ref.yaml", tmp_path / "port.yaml"
    ref_path.write_text(config.format(port=_free_port(), num_proxies=1,
                                      import_path="tests.serve_yaml_app:app"))
    # The port's serve keeps its proxies: the YAML names them as they are.
    port_path.write_text(config.format(port=port_serve, num_proxies=2,
                                       import_path="_torch_serve_apps:greeter_app"))
    try:
        deployed = [ref.run_from_config(str(ref_path)), serve.run_from_config(str(port_path))]
        assert deployed[0] == deployed[1] == {"yamlapp": "Greeter"}
        for package in (ref, serve):
            status = package.status()["yamlapp"]
            assert status["status"] == "RUNNING"
            assert status["deployments"]["Greeter"]["running_replicas"] == 2
            assert package.get_app_handle("yamlapp").remote("world").result() == "hola world"
        assert _http(port_serve, "POST", "/yaml", "there") == (200, b"hola there")
        assert len(_controller("get_proxies")) == 2
    finally:
        ref.shutdown()
        serve.delete("yamlapp")


def test_grpc_proxy_matches_the_reference(ray_start_shared, port_serve):
    """tests/test_serve.py's gRPC test through both packages: unary and
    streaming replies, and NOT_FOUND for an unknown route."""
    import grpc

    from ray_tpu import serve as ref

    @ref.deployment
    class GrpcEcho:
        def __call__(self, body):
            return {"grpc_echo": body}

    @ref.deployment
    class GrpcTokens:
        def __call__(self, body):
            def gen():
                yield from ["alpha", "beta", "gamma"]
            return gen()

    ref_port, our_port = _free_port(), _free_port()
    ref.run(GrpcEcho.bind(), name="gecho", route_prefix="/gecho", grpc_port=ref_port)
    ref.run(GrpcTokens.bind(), name="gtok", route_prefix="/gtok", grpc_port=ref_port)
    serve.run(apps.GrpcEcho.bind(), name="gecho", route_prefix="/gecho", grpc_port=our_port)
    serve.run(apps.GrpcTokens.bind(), name="gtok", route_prefix="/gtok", grpc_port=our_port)
    replies = []
    try:
        for port in (ref_port, our_port):
            channel = grpc.insecure_channel(f"127.0.0.1:{port}")
            predict = channel.unary_unary("/raytpu.serve.Serve/Predict",
                                          request_serializer=lambda b: b,
                                          response_deserializer=lambda b: b)
            stream = channel.unary_stream("/raytpu.serve.Serve/PredictStream",
                                          request_serializer=lambda b: b,
                                          response_deserializer=lambda b: b)
            unary = predict(json.dumps({"route": "/gecho", "data": {"x": 7}}).encode(),
                            timeout=60)
            tokens = list(stream(json.dumps({"route": "/gtok", "data": None}).encode(),
                                 timeout=60))
            whole = predict(json.dumps({"route": "/gtok"}).encode(), timeout=60)
            with pytest.raises(grpc.RpcError) as missing:
                predict(json.dumps({"route": "/nope"}).encode(), timeout=30)
            with pytest.raises(grpc.RpcError) as bad:
                predict(b"not json", timeout=30)
            replies.append((unary, tokens, whole, missing.value.code(), missing.value.details(),
                            bad.value.code()))
            channel.close()
    finally:
        ref.shutdown()
        serve.delete("gecho")
        serve.delete("gtok")
    assert replies[0] == replies[1]
    unary, tokens, whole, code, details, bad = replies[1]
    assert json.loads(unary) == {"grpc_echo": {"x": 7}}
    assert [json.loads(t) for t in tokens] == ["alpha", "beta", "gamma"]
    assert json.loads(whole) == ["alpha", "beta", "gamma"]
    assert code == grpc.StatusCode.NOT_FOUND and details == "no Serve route for '/nope'"
    assert bad == grpc.StatusCode.INVALID_ARGUMENT


def _pids_by_session(handle, replicas: int = 2) -> dict:
    """{replica pid: a session id the ring sends to it}."""
    pids = {}
    for i in range(64):
        pids.setdefault(handle.options(session_id=f"s{i}").remote({}).result(timeout=30),
                        f"s{i}")
        if len(pids) == replicas:
            return pids
    raise AssertionError(f"sessions reached {len(pids)} replicas")


def test_a_hedge_on_a_slow_replica_wins_on_the_other(port_serve):
    handle = serve.run(apps.Hedged.bind(), name="hedged", route_prefix="/hedged")
    pids = _pids_by_session(handle)
    slow, fast = list(pids)
    router = handle._get_router()
    before = dict(router.stats)
    start = time.monotonic()
    got = handle.options(session_id=pids[slow]).remote(
        {"slow_pid": slow, "sleep_s": 20.0}).result(timeout=30)
    took = time.monotonic() - start
    assert got == fast and 0.2 <= took < 5.0
    assert router.stats["hedges_launched"] - before.get("hedges_launched", 0) == 1
    assert router.stats["hedges_won"] - before.get("hedges_won", 0) == 1
    assert sum(router._ongoing.values()) == 0
    # The loser's sleep was cancelled in its replica.
    _wait(lambda: handle.options(session_id=pids[slow], method_name="cancels")
          .remote(0).result(timeout=30) == 1, 10, "the lost attempt's cancel")
    # A fast primary answers before the hedge's delay: no hedge.
    assert handle.options(session_id=pids[fast]).remote({}).result(timeout=30) == fast
    assert router.stats["hedges_launched"] - before.get("hedges_launched", 0) == 1
    serve.delete("hedged")


def test_a_failing_replicas_breaker_opens_and_drops_it(port_serve, monkeypatch):
    """A replica whose calls fail as a dead actor's do while the membership
    still lists it: three failed attempts, each retried on the other
    replica, open its breaker; then its requests go to the other replica
    without trying it, and after the cooldown a probe that succeeds closes
    the breaker."""
    handle = serve.run(apps.Pid.bind(), name="breaker", route_prefix="/breaker")
    pids = _pids_by_session(handle)
    router = handle._get_router()
    monkeypatch.setattr(port_handle_mod.Router, "BAN_S", 0.0)
    router.refresh()
    victim = router._replicas[0]
    session = next(f"k{i}" for i in range(1000)
                   if routing.HashRing(router._replicas).rank(f"k{i}")[0] == victim)
    victim_pid = handle.options(session_id=session).remote({}).result(timeout=30)
    real_call = router.call

    async def call(replica, method, *args):
        if replica == victim:
            raise rt.exceptions.ActorDiedError(f"actor {victim} died")
        return await real_call(replica, method, *args)

    monkeypatch.setattr(router, "call", call)
    retries = router.stats["retries"]
    other_pid = next(p for p in pids if p != victim_pid)
    for _ in range(3):
        assert handle.options(session_id=session).remote({}).result(timeout=30) == other_pid
    breaker = router.breaker(victim)
    assert breaker.state == breaker.OPEN and router.stats["retries"] - retries == 3
    for _ in range(5):
        assert handle.options(session_id=session).remote({}).result(timeout=30) == other_pid
    assert router.stats["retries"] - retries == 3  # the open breaker kept it out
    breaker.cooldown_s = 0.2
    monkeypatch.setattr(router, "call", real_call)
    time.sleep(0.3)
    assert handle.options(session_id=session).remote({}).result(timeout=30) == victim_pid
    assert breaker.state == breaker.CLOSED
    assert {"open", "closed"} <= set(router.reliability()["breaker_states_seen"])
    serve.delete("breaker")


def test_a_killed_proxy_is_restarted_on_its_port(port_serve):
    serve.run(apps.Echo.bind(), name="echo", route_prefix="/echo")
    second = next(p for p in _controller("get_proxies") if p["port"] == port_serve + 1)
    assert second["pid"] != os.getpid() and second["restarts"] == 0
    assert _http(port_serve + 1, "POST", "/echo", 1) == (200, b'{"echo": 1}')
    os.kill(second["pid"], signal.SIGKILL)
    # The first proxy serves on meanwhile.
    assert _http(port_serve, "POST", "/echo", 2) == (200, b'{"echo": 2}')

    def back():
        now = next(p for p in _controller("get_proxies") if p["port"] == port_serve + 1)
        try:
            return now["restarts"] == 1 and _http(port_serve + 1, "GET", "/-/healthz")[1] == b"ok"
        except OSError:
            return False

    _wait(back, 60, "the second proxy's restart")
    assert _http(port_serve + 1, "POST", "/echo", 3) == (200, b'{"echo": 3}')
    now = next(p for p in _controller("get_proxies") if p["port"] == port_serve + 1)
    assert now["pid"] != second["pid"]
    assert _controller("proxy_call", now["name"], "get_num_requests") == 1
    serve.delete("echo")


def test_the_route_p99_reaches_the_controller_and_adds_a_replica(port_serve):
    serve.run(apps.SloScaled.bind(), name="slo", route_prefix="/slo")
    running = lambda: serve.status()["slo"]["deployments"]["SloScaled"]["running_replicas"]  # noqa: E731
    assert running() == 1
    for i in range(12):
        assert _http(port_serve, "POST", "/slo", i) == (200, str(i).encode())
    stats = _controller("proxy_call", f"SERVE_PROXY::{port_serve}", "get_route_stats")
    assert stats["slo_SloScaled"]["count"] == 12 and stats["slo_SloScaled"]["p99_ms"] > 100
    _wait(lambda: _controller("get_route_p99").get("slo_SloScaled", 0) > 50.0, 10,
          "the scraped route p99")
    # One replica answers 12 requests in turn: only the p99 asks for more.
    _wait(lambda: running() == 2, 40, "a second replica above slo_p99_ms")
    serve.delete("slo")


def test_resources_a_host_never_declared_pend(port_serve):
    """The cluster declares one accelerator slot and one TPU: a replica
    holds them, a second asking for them pends (PENDING in the status)
    until the first goes, and the runtime's table counts the lease."""
    serve.run(apps.OnASlot.bind(), name="holder", route_prefix="/holder")
    assert rt.available_resources().get("accelerator_slot", 0.0) == 0.0
    try:
        with pytest.raises(TimeoutError):
            serve.run(apps.OnASlot.bind(), name="slot", route_prefix="/slot",
                      _blocking_timeout_s=1.5)
        assert serve.status()["slot"]["deployments"]["OnASlot"]["states"] == ["PENDING"]
        serve.delete("holder")
        handle = serve.get_app_handle("slot")
        _wait(lambda: serve.status()["slot"]["status"] == "RUNNING", 30, "the placed replica")
        assert handle.remote(5).result(timeout=30) == 5
        assert rt.available_resources().get("accelerator_slot", 0.0) == 0.0
        assert rt.available_resources().get("TPU", 0.0) == 0.0
    finally:
        serve.delete("slot")
        if "holder" in serve.status():
            serve.delete("holder")
    _wait(lambda: rt.available_resources().get("accelerator_slot") == 1.0, 30,
          "the slot given back")


def test_hedge_and_slo_options_are_taken():
    dep = serve.deployment(retry_policy={"hedge": True}, autoscaling_config={"slo_p99_ms": 50.0},
                           ray_actor_options={"num_tpus": 1, "resources": {"x": 1}})(
        apps.noop.func_or_class)
    assert dep._config.retry_policy.hedge
    assert dep._config.autoscaling_config.slo_p99_ms == 50.0
    with pytest.raises(ValueError, match="replicas take"):
        serve.deployment(ray_actor_options={"memory": 1})(apps.noop.func_or_class)
