"""The port's serve plane (ray_tpu_torch.serve) on the CPU.

Against the JAX package: the autoscaling decisions and the hash ring over
grids of inputs, the route match, and, with the reference's serve booted
once for the module (a local ray_tpu cluster), the same seeded requests
over HTTP to both proxies: the tiny model's answers (f32, behind @batch)
within 2e-5, the status codes and texts of an unknown route, a user
exception and an expired deadline, and a generator's SSE lines byte for
byte. Then the port alone, mirroring tests/test_serve.py: deployments,
composition, reconfigure, @batch, a replica's death, delete, streaming, a
route added after start, autoscaling from 1 to 2 replicas and back,
half-card replicas sharing the card the node agent leased, the controller's
checkpoint through the runtime's KV, the refusal that waits for ROADMAP
item 14d, and kv_headroom_min taken. Serve runs on a runtime cluster the
module boots (``ray_tpu_torch.init`` with 32 CPUs and one declared card,
so that no real card is needed), shut down at the module's end; replicas are
actors on the CPU unless they ask for a share of the declared card; the
deployments live in tests/_torch_serve_apps.py, since replicas import
them by name.
"""

import concurrent.futures
import http.client
import json
import os
import pickle
import re
import signal
import socket
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu.serve._private import autoscaling_policy as ref_policy
from ray_tpu.serve._private import routing as ref_routing
from ray_tpu.serve._private.common import AutoscalingConfig as RefAutoscalingConfig

import _torch_serve_apps as apps
import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.serve import autoscaling_policy, long_poll, routing
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.replica import CallableRef

# f32 forward of the tiny model, the ROADMAP parity rules' bound.
ANSWER_TOL = 2e-5


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _http(port: int, method: str, path: str, body=None, headers=None):
    """(status, headers, body bytes) of one request, by http.client."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = None if body is None else json.dumps(body)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


# The runtime's retry settings for calls to dead actors, as the port's core
# tests set them: a killed replica's callers fail fast.
SYSTEM_CONFIG = {"rpc_retry_max_backoff_s": 0.05, "rpc_retry_max_attempts": 6}


def _wait(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


# ---------------------------------------------------------------- pure math
AUTOSCALING_CONFIGS = [
    dict(min_replicas=1, max_replicas=10, target_ongoing_requests=2.0),
    dict(min_replicas=0, max_replicas=4, target_ongoing_requests=8.0, queue_weight=0.5),
    dict(min_replicas=1, max_replicas=2, target_ongoing_requests=8, upscale_delay_s=1.0),
    dict(min_replicas=2, max_replicas=20, target_ongoing_requests=3.0,
         upscale_smoothing_factor=0.5, downscale_smoothing_factor=0.25),
]


@pytest.mark.parametrize("kwargs", AUTOSCALING_CONFIGS, ids=lambda k: str(sorted(k.items())))
def test_desired_replicas_match_the_reference(kwargs):
    ours, ref = serve.AutoscalingConfig(**kwargs), RefAutoscalingConfig(**kwargs)
    for load in (0.0, 0.5, 2.0, 7.5, 16.0, 30.0, 200.0):
        for current in (0, 1, 2, 5, 10):
            for queue in (0.0, 3.0, 12.0):
                got = autoscaling_policy.calculate_desired_num_replicas(
                    ours, load, current, queue_depth=queue)
                want = ref_policy.calculate_desired_num_replicas(
                    ref, load, current, queue_depth=queue)
                assert got == want, (load, current, queue)


@pytest.mark.parametrize("kwargs", AUTOSCALING_CONFIGS, ids=lambda k: str(sorted(k.items())))
def test_autoscaling_state_decisions_match_the_reference(kwargs):
    rng = np.random.default_rng(3)
    delays = dict(upscale_delay_s=kwargs.get("upscale_delay_s", 1.5), downscale_delay_s=4.0)
    ours = autoscaling_policy.AutoscalingState(serve.AutoscalingConfig(**{**kwargs, **delays}))
    ref = ref_policy.AutoscalingState(RefAutoscalingConfig(**{**kwargs, **delays}))
    now, current = 0.0, max(1, kwargs["min_replicas"])
    for _ in range(400):
        now += float(rng.choice([0.1, 0.25, 0.5, 1.0, 2.5]))
        load = float(rng.choice([0, 1, 4, 9, 20, 60]))
        queue = float(rng.choice([0, 0, 2, 10]))
        got = ours.decide(load, current, now=now, queue_depth=queue)
        assert got == ref.decide(load, current, now=now, queue_depth=queue)
        current = got


@pytest.mark.parametrize("members", [["a"], ["r1", "r2"], [f"app_D#{i:06x}" for i in range(5)]])
def test_hash_ring_matches_the_reference(members):
    ours, ref = routing.HashRing(members), ref_routing.HashRing(members)
    rng = np.random.default_rng(len(members))
    for i in range(50):
        key = f"key-{i}-{rng.integers(1 << 30)}"
        assert ours.rank(key) == ref.rank(key)
        load = {m: int(rng.integers(0, 4)) for m in members}
        for max_load in (None, 1, 2, 4):
            assert (ours.pick(key, load=load, max_load=max_load)
                    == ref.pick(key, load=load, max_load=max_load))
    assert ours.pick("k", load={}, max_load=1) == ref.pick("k", load={}, max_load=1)
    assert routing.HashRing().pick("k") is None


def test_route_match_matches_the_reference():
    routes = {"/": "a_Root", "/bert": "b_Bert", "/bert/v2": "c_Bert2", "/stream": "d_S"}
    mixin = ref_routing.RoutingMixin()
    mixin._routes = routes
    for path in ("/", "/bert", "/bert/", "/bert/v2/x", "/bertx", "/stream", "/nope", "/-/x"):
        assert routing.match_route(routes, path) == mixin._match(path)
    assert routing.match_route({"/a": "x_A"}, "/b") is None


def test_placement_packs_fractional_shares(port_serve):
    """Two replicas at num_gpus 0.5 share the one declared card through the
    node agent's leases; a third waits as PENDING until a share frees."""
    handle = serve.run(apps.OnHalfACard.options(num_replicas=2).bind(), name="half",
                       route_prefix="/half")
    seen = {handle.options(session_id=f"s{i}").visible.remote(0).result(timeout=30)
            for i in range(16)}
    assert seen == {"0"}
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    controller = serve.start(http_port=None)
    specs = serve.api.Application(apps.OnHalfACard.options(num_replicas=3), (), {})._collect(
        "half", {})
    rt.get(controller.deploy_application.remote("half", specs, "/half"), timeout=30)
    _wait(lambda: sorted(serve.status()["half"]["deployments"]["OnHalfACard"]["states"])
          == ["PENDING", "RUNNING", "RUNNING"], 20, "a third replica pending")
    serve.delete("half")
    _wait(lambda: rt.available_resources().get("GPU", 0.0) == 1.0, 30,
          "the card's shares back")


def test_a_local_class_is_refused():
    class Local:
        pass

    with pytest.raises(ValueError, match="top level"):
        CallableRef(Local)
    assert CallableRef(apps.Doubler.func_or_class).resolve() is apps.Doubler.func_or_class


@pytest.mark.parametrize("make, item", [
    (lambda c: c._drain_oom_flagged(), "14d"),
], ids=["oom_drain"])
def test_left_out_features_raise_naming_their_roadmap_item(make, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue A item {item}"):
        make(ServeController.__new__(ServeController))


def test_kv_headroom_min_is_accepted_and_carried():
    """The serve-LLM engine feeds kv_headroom_min (tests/test_torch_serve_llm.py
    scales a decode pool on it); the deployment keeps the floor."""
    dep = serve.deployment(autoscaling_config={"kv_headroom_min": 0.2})(apps.noop.func_or_class)
    assert dep._config.autoscaling_config.kv_headroom_min == 0.2
    again = dep.options(autoscaling_config={"kv_headroom_min": 0.5, "max_replicas": 3})
    assert again._config.autoscaling_config.kv_headroom_min == 0.5
    assert dep._config.autoscaling_config.kv_headroom_min == 0.2


# ------------------------------------------------------ the serve instances
def _run_all(apps_to_run: dict) -> dict:
    """serve.run of each (name -> (application, route)) at once: replicas
    start in parallel. Returns each application's handle."""
    with concurrent.futures.ThreadPoolExecutor(len(apps_to_run)) as pool:
        futures = {name: pool.submit(serve.run, app, name=name, route_prefix=route)
                   for name, (app, route) in apps_to_run.items()}
        return {name: future.result() for name, future in futures.items()}


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=32, num_gpus=1, _system_config=SYSTEM_CONFIG)
    yield
    serve.shutdown()
    rt.shutdown()


@pytest.fixture(scope="module")
def port_serve(cluster):
    port = _free_port()
    serve.start(http_port=port)
    yield port
    serve.shutdown()


@pytest.fixture(scope="module")
def handles(port_serve):
    """The applications the tests below only call, deployed together."""
    return _run_all({
        "doubler": (apps.Doubler.bind(), "/double"),
        "square": (apps.square.bind(), "/square"),
        "composed": (apps.Model.bind(apps.Preprocess.bind()), "/composed"),
        "calc": (apps.Calculator.bind(100), "/calc"),
        "batched": (apps.BatchedModel.bind(), "/batched"),
        "fragile": (apps.Fragile.bind(), "/fragile"),
        "streamer": (apps.TokenStreamer.bind(), "/tokens"),
        "boomer": (apps.Boomer.bind(), "/boomer"),
        "echo2": (apps.Echo.bind(), "/echo2"),
        "watcher": (apps.RouteWatcher.bind(), "/watcher"),
    })


@pytest.fixture(scope="module")
def tiny_params():
    params = jt.init_params(jt.TransformerConfig.tiny(), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ref_serve(ray_start_shared, tiny_params, port_serve):
    """The reference's serve with the same applications as the port's."""
    from ray_tpu import serve as ref

    @ref.deployment(max_ongoing_requests=64)
    class TinyEncoder:
        def __init__(self, numpy_params):
            import jax
            import jax.numpy as jnp

            from ray_tpu.models.transformer import TransformerConfig, forward

            self.config = TransformerConfig.tiny()
            self.params = jax.tree.map(jnp.asarray, numpy_params)
            self._forward = jax.jit(lambda params, tokens: forward(params, tokens, self.config))
            for bucket in (1, 4, 8):
                jax.block_until_ready(self._forward(self.params, jnp.zeros((bucket, 16), jnp.int32)))

        @ref.batch(max_batch_size=8, batch_wait_timeout_s=0.005, bucket_sizes=[1, 4, 8])
        async def __call__(self, bodies):
            import jax
            import jax.numpy as jnp
            import numpy as np

            tokens = np.zeros((len(bodies), 16), dtype=np.int32)
            for i, body in enumerate(bodies):
                ids = (body or {}).get("token_ids") or [101, 102]
                tokens[i, : min(len(ids), 16)] = ids[:16]
            logits = jax.block_until_ready(self._forward(self.params, jnp.asarray(tokens)))
            out = np.asarray(logits[:, 0, :8], dtype=np.float64)
            return [{"embedding": row.tolist()} for row in out]

    @ref.deployment
    class Boom:
        def __call__(self, body):
            raise ValueError("boom")

    @ref.deployment
    class Echo:
        def __call__(self, body):
            return {"echo": body}

    @ref.deployment
    class TokenStreamer:
        def __call__(self, body):
            n = int((body or {}).get("n", 8))
            for i in range(n):
                yield {"token": f"t{i}"}

    ref_port = _free_port()
    ref.start(http_port=ref_port)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # The reference deploys one application after another meanwhile.
        ref_done = pool.submit(lambda: [
            ref.run(TinyEncoder.bind(tiny_params), name="tiny", route_prefix="/tiny"),
            ref.run(Boom.bind(), name="boom", route_prefix="/boom"),
            ref.run(Echo.bind(), name="echo", route_prefix="/echo"),
            ref.run(TokenStreamer.bind(), name="stream", route_prefix="/stream")])
        _run_all({"tiny": (apps.TinyEncoder.bind(tiny_params), "/tiny"),
                  "boom": (apps.Boom.bind(), "/boom"), "echo": (apps.Echo.bind(), "/echo"),
                  "stream": (apps.TokenStreamer.bind(), "/stream")})
        ref_done.result()
    yield {"ref": ref_port, "port": port_serve}
    ref.shutdown()
    for name in ("tiny", "boom", "echo", "stream"):
        serve.delete(name)


# ------------------------------------------------------- against the reference
def test_http_answers_match_the_reference_serve(ref_serve):
    rng = np.random.default_rng(14)
    bodies = [{"token_ids": rng.integers(0, 256, int(rng.integers(1, 20))).tolist()}
              for _ in range(24)]

    def answers(port):
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            replies = list(pool.map(lambda b: _http(port, "POST", "/tiny", b), bodies))
        assert all(status == 200 for status, _, _ in replies), replies[:2]
        return np.array([json.loads(data)["embedding"] for _, _, data in replies])

    ours, ref = answers(ref_serve["port"]), answers(ref_serve["ref"])
    assert ours.shape == ref.shape == (24, 8)
    assert np.isfinite(ours).all() and np.abs(ours).max() > 1e-3
    assert np.abs(ours - ref).max() < ANSWER_TOL


def _last_line(text: str) -> str:
    return [line for line in text.splitlines() if line.strip()][-1]


@pytest.mark.parametrize("case", ["unknown_route", "user_exception", "expired_deadline"])
def test_http_errors_match_the_reference(ref_serve, case):
    path, headers = {"unknown_route": ("/nope/x", {}), "user_exception": ("/boom", {}),
                     "expired_deadline": ("/echo", {"X-RayTPU-Deadline": "0"})}[case]
    ours = _http(ref_serve["port"], "POST", path, {"a": 1}, headers)
    ref = _http(ref_serve["ref"], "POST", path, {"a": 1}, headers)
    assert ours[0] == ref[0] and ours[1]["Content-Type"] == ref[1]["Content-Type"]
    if case == "user_exception":
        # "TaskError: task '<replica>.handle_request' failed remotely:" and
        # the traceback; its frames are each package's own.
        head = r"^TaskError: task '[^']+\.handle_request' failed remotely:\nTraceback"
        for text in (ours[2].decode(), ref[2].decode()):
            assert re.match(head, text), text[:200]
        assert _last_line(ours[2].decode()) == _last_line(ref[2].decode()) == "ValueError: boom"
    else:
        assert ours[2] == ref[2]
        assert ours[0] in (404, 504)


@pytest.mark.parametrize("accept", ["text/event-stream", None], ids=["sse", "chunked"])
def test_stream_lines_match_the_reference(ref_serve, accept):
    headers = {"Accept": accept} if accept else {}
    ours = _http(ref_serve["port"], "POST", "/stream", {"n": 5}, headers)
    ref = _http(ref_serve["ref"], "POST", "/stream", {"n": 5}, headers)
    assert ours[0] == ref[0] == 200
    assert ours[1]["Content-Type"] == ref[1]["Content-Type"]
    assert ours[2] == ref[2]
    lines = ours[2].decode().splitlines()
    if accept:
        assert [line for line in lines if line.startswith("data: ")] == [
            f'data: {{"token": "t{i}"}}' for i in range(5)]


# ---------------------------------------------------------------- the port
def test_basic_deployment(handles):
    handle = handles["doubler"]
    assert handle.remote(21).result() == 42
    assert [handle.remote(i).result() for i in range(10)] == [2 * i for i in range(10)]
    status = serve.status()
    assert status["doubler"]["status"] == "RUNNING"
    assert status["doubler"]["deployments"]["Doubler"]["running_replicas"] == 2
    # Keyless requests spread over both replicas.
    assert len({handle.pid.remote(i).result() for i in range(20)}) == 2


def test_many_threads_share_one_handle(handles):
    """32 threads call one handle (and option clones of it) with the
    interpreter switching threads as often as it can: every answer is
    right, and every slot the router took is given back."""
    handle = handles["doubler"]
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def caller(i):
            mine = handle if i % 2 else handle.options(method_name="__call__")
            return [mine.remote(i * 100 + j).result(timeout=60) for j in range(10)]

        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            results = list(pool.map(caller, range(32)))
    finally:
        sys.setswitchinterval(before)
    assert results == [[2 * (i * 100 + j) for j in range(10)] for i in range(32)]
    router = handle._get_router()
    assert handle.options(method_name="pid")._get_router() is router
    assert sum(router._ongoing.values()) == 0


def test_function_deployment(handles):
    handle = handles["square"]
    assert handle.remote(7).result() == 49


def test_composition(handles):
    handle = handles["composed"]
    assert handle.remote(4).result() == 50
    # A response passed to another call composes.
    pre = serve.get_deployment_handle("Preprocess", "composed")
    assert handle.remote(pre.remote(1)).result() == 30


def test_method_calls_and_init_args(handles):
    handle = handles["calc"]
    assert handle.add.remote(1).result() == 101
    assert handle.sub.remote(1).result() == -99
    assert handle.options(method_name="add").remote(2).result() == 102


def test_user_config_reconfigure(port_serve):
    handle = serve.run(apps.Thresholder.bind(), name="thresh", route_prefix="/thresh")
    assert handle.remote(1).result() is True
    pid = handle.pid.remote(0).result()
    handle = serve.run(apps.Thresholder.options(user_config={"threshold": 5}).bind(),
                       name="thresh", route_prefix="/thresh")
    _wait(lambda: handle.remote(3).result() is False, 20, "the new user_config")
    assert handle.remote(7).result() is True
    # Reconfigured in place: the same replica, not a rolled one.
    assert handle.pid.remote(0).result() == pid


def test_batch_in_deployment_strips_bucket_padding(handles):
    handle = handles["batched"]
    responses = [handle.remote(i) for i in range(12)]
    assert [r.result() for r in responses] == [i + 1000 for i in range(12)]
    sizes = handle.sizes.remote(0).result()
    assert sizes and set(sizes) <= {4, 8}


def test_replica_death_is_replaced_and_the_request_retried(handles):
    handle = handles["fragile"]
    pid = handle.pid.remote(0).result()
    pending = handle.slow.remote(7)
    time.sleep(0.3)
    os.kill(pid, signal.SIGKILL)
    # The in-flight request is sent again, to the replacement, within its
    # RetryPolicy (3 attempts) and deadline (60 s).
    assert pending.result(timeout=60) == 7
    assert handle.pid.remote(0).result() != pid
    status = serve.status()["fragile"]["deployments"]["Fragile"]
    assert status["running_replicas"] == 1


def test_delete_application(port_serve):
    serve.run(apps.noop.bind(), name="temp", route_prefix="/temp")
    assert "temp" in serve.status()
    serve.delete("temp")
    _wait(lambda: "temp" not in serve.status(), 20, "the application to go")
    assert _http(port_serve, "POST", "/temp", 1)[0] == 404


def test_streaming_handle_and_http(port_serve, handles):
    handle = handles["streamer"]
    stream = handle.remote({"n": 5}).result()
    assert isinstance(stream, serve.ResponseStream)
    assert list(stream) == [{"token": f"t{i}"} for i in range(5)]
    status, headers, body = _http(port_serve, "POST", "/tokens", {"n": 4})
    assert status == 200 and headers["Transfer-Encoding"] == "chunked"
    assert body.decode().splitlines() == [json.dumps({"token": f"t{i}"}) for i in range(4)]
    status, headers, body = _http(port_serve, "POST", "/tokens", {"n": 32},
                                  {"Accept": "text/event-stream"})
    assert headers["Content-Type"].startswith("text/event-stream")
    events = [line for line in body.decode().splitlines() if line.startswith("data: ")]
    assert len(events) == 32


def test_streaming_error_propagates(handles):
    handle = handles["boomer"]
    items = []
    with pytest.raises(RuntimeError, match="mid-stream bang"):
        for item in handle.remote({}).result():
            items.append(item)
    assert items == ["first"]


def test_http_proxy_health_routes_and_query(port_serve, handles):
    assert _http(port_serve, "GET", "/-/healthz")[2] == b"ok"
    assert json.loads(_http(port_serve, "GET", "/-/routes")[2])["/echo2"] == "echo2_Echo"
    assert json.loads(_http(port_serve, "GET", "/echo2?x=1")[2]) == {"echo": {"x": "1"}}
    # A malformed request line and a flood of headers get a 400.
    with socket.create_connection(("127.0.0.1", port_serve), timeout=30) as raw:
        raw.sendall(b"NOT-HTTP\r\n\r\n")
        assert raw.recv(64).startswith(b"HTTP/1.1 400 Bad Request")
    with socket.create_connection(("127.0.0.1", port_serve), timeout=30) as raw:
        raw.sendall(b"GET /echo2 HTTP/1.1\r\n" + b"X-A: b\r\n" * 101 + b"\r\n")
        assert raw.recv(64).startswith(b"HTTP/1.1 400 Bad Request")
    # Keep-alive: several requests on one connection.
    conn = http.client.HTTPConnection("127.0.0.1", port_serve, timeout=30)
    for i in range(3):
        conn.request("POST", "/echo2", body=json.dumps(i))
        assert json.loads(conn.getresponse().read()) == {"echo": i}
    conn.close()


def test_a_route_added_after_start_is_reached(handles):
    watcher = handles["watcher"]
    assert "/pushed" not in watcher.routes.remote(0).result()
    serve.run(apps.pong.bind(), name="pushed", route_prefix="/pushed")
    # Inside the watcher's replica: the controller's push brings the route.
    _wait(lambda: "/pushed" in watcher.routes.remote(0).result(), 15,
          "the route in the replica")
    assert watcher.call.remote(("pushed", 3)).result() == ("pong", 3)
    qualified = long_poll.get_subscriber().get_routes()["/pushed"]
    assert long_poll.get_subscriber().get_replicas(qualified)["actor_names"]


def test_autoscaling_from_one_to_two_and_back(port_serve):
    handle = serve.run(apps.Autoscaled.bind(), name="auto", route_prefix="/auto")
    running = lambda: serve.status()["auto"]["deployments"]["Autoscaled"]["running_replicas"]  # noqa: E731
    assert running() == 1
    stop = threading.Event()

    def load():
        while not stop.is_set():
            handle.remote(1).result(timeout=30)

    threads = [threading.Thread(target=load) for _ in range(6)]
    for t in threads:
        t.start()
    try:
        _wait(lambda: running() == 2, 30, "a second replica under load")
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not any(t.is_alive() for t in threads)
    _wait(lambda: running() == 1 and len(
        serve.status()["auto"]["deployments"]["Autoscaled"]["states"]) == 1, 30,
        "the scale-down to one replica")


def test_num_gpus_on_a_host_without_a_card_raises(port_serve, monkeypatch):
    # A cluster whose node agent found no card.
    monkeypatch.setattr(rt, "cluster_resources", lambda: {"CPU": 32.0, "GPU": 0.0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(apps.OnHalfACard.bind(), name="gpu", route_prefix="/gpu")
    assert "gpu" not in serve.status()


def test_a_deployment_replicas_cannot_import_or_receive_is_refused(port_serve):
    def local(x):
        return x

    with pytest.raises(ValueError, match="top level"):
        serve.run(serve.deployment(local).bind(), name="local", route_prefix="/local")
    with pytest.raises(TypeError, match="must pickle"):
        serve.run(apps.Calculator.bind(lambda: 1), name="lam", route_prefix="/lam")
    assert "local" not in serve.status() and "lam" not in serve.status()


def test_a_constructor_that_raises_fails_the_deploy(port_serve):
    # Three replicas fail in a row; serve.run raises with the traceback.
    with pytest.raises(RuntimeError, match="(?s)failed to deploy.*constructor bang"):
        serve.run(apps.BrokenInit.bind(), name="broken", route_prefix="/broken")
    assert serve.status()["broken"]["status"] == "DEPLOY_FAILED"
    serve.delete("broken")


def _kv_checkpoint() -> dict:
    from ray_tpu_torch._private import worker

    ctx = worker.get_global_context()
    resp = ctx.io.run(ctx.controller.call(
        "kv_get", {"namespace": "serve", "key": "controller_checkpoint"}))
    return pickle.loads(resp["value"])


@pytest.mark.parametrize("step", ["save", "restore"])
def test_the_controller_checkpoint_round_trips_through_the_kv(handles, step):
    """The target state sits in the runtime controller's KV; a controller
    started again (the old one killed) restores it, takes back the live
    replicas, and a delete afterwards leaves the KV."""
    state = _kv_checkpoint()
    assert "doubler_Doubler" in state["deployments"]
    assert state["routes"]["/double"] == "doubler_Doubler"
    if step == "restore":
        apps_before = set(serve.status())
        rt.kill(rt.get_actor("SERVE_CONTROLLER"))
        _wait(lambda: _no_controller(), 20, "the controller's name to free")
        serve.start(http_port=None)
        _wait(lambda: serve.status().get("doubler", {}).get("status") == "RUNNING", 60,
              "the restored application")
        assert set(serve.status()) == apps_before
        # The live replicas were taken back, not started again.
        assert serve.status()["doubler"]["deployments"]["Doubler"]["states"] == [
            "RUNNING", "RUNNING"]
        assert handles["doubler"].remote(21).result(timeout=30) == 42
        serve.delete("square")
        assert "square_square" not in _kv_checkpoint()["deployments"]


def _no_controller() -> bool:
    try:
        rt.get_actor("SERVE_CONTROLLER")
        return False
    except ValueError:
        return True
