"""The port's g++ build of the native engine, store and fast lane, here.

The gist of the reference's ``tests/test_object_store.py``,
``test_rpc_transport.py``, ``test_native_calls.py`` and
``test_fastlane.py`` on the port's copies (``ray_tpu_torch/_native/src/``),
built into ``build/ray_tpu_torch/native/``:

* the store: create, seal and a zero-copy read-only get, a blocking get
  woken by a seal, eviction with spill and transparent restore, pins that
  survive pressure, delete, and a full store without spill;
* the engine: framing and request/reply over the native call table, an
  error reply, and a handler's error reaching the caller;
* the fast lane: its reply encode byte-equal to ``wire_gen.encode_task_reply``
  and its scanners reading what the generated codecs write.
"""

import asyncio
import ctypes
import os
import threading
import time
from pathlib import Path

import msgpack
import pytest

from ray_tpu_torch import _native
from ray_tpu_torch._private import wire_gen
from ray_tpu_torch._private.object_store import (
    ObjectStoreClient,
    ObjectStoreFull,
    ObjectStoreServer,
)
from ray_tpu_torch._private.rpc import (
    ERR, REP, IoThread, RpcClient, RpcError, RpcServer, native_available,
)

ROOT = Path(__file__).resolve().parent.parent


def test_the_libraries_build_from_the_ports_sources_into_build():
    lib, ext = Path(_native.build()), Path(_native.build_fastlane())
    for path in (lib, ext):
        assert path.parent == ROOT / "build" / "ray_tpu_torch" / "native"
        assert path.exists()
    assert all(Path(s).is_relative_to(ROOT / "ray_tpu_torch" / "_native" / "src")
               for s in _native._sources())
    # The same sources give the same library: a second build compiles nothing.
    before = lib.stat().st_mtime_ns
    assert Path(_native.build()) == lib and lib.stat().st_mtime_ns == before
    assert native_available()


def test_the_fast_lane_loads_or_says_why():
    fl = _native.load_fastlane()
    assert fl is not None, _native.fastlane_off_reason
    assert _native.fastlane_off_reason is None


@pytest.fixture
def store(tmp_path):
    sock = str(tmp_path / "store.sock")
    shm = f"/dev/shm/raytpu_torch-test-{os.getpid()}-{time.monotonic_ns()}"
    capacity = 1 << 20
    server = ObjectStoreServer(sock, shm, capacity, spill_dir=str(tmp_path / "spill"))
    client = ObjectStoreClient(sock, shm, capacity)
    yield client, sock, shm, capacity
    client.close()
    server.stop()
    assert not os.path.exists(shm)


def test_create_seal_and_a_zero_copy_read_only_get(store):
    client, *_ = store
    data = os.urandom(4096)
    view = client.create("z", len(data))
    view[:] = data
    client.seal("z")
    got = client.get("z")
    assert isinstance(got, memoryview) and got.readonly and bytes(got) == data
    client.release("z")
    assert client.contains("z") and not client.contains("nope")


def test_a_blocking_get_wakes_on_seal(store):
    client, sock, shm, capacity = store
    other = ObjectStoreClient(sock, shm, capacity)
    result = []
    thread = threading.Thread(
        target=lambda: result.append(bytes(other.get("late", timeout_ms=5000))))
    thread.start()
    time.sleep(0.05)
    client.put("late", b"worth-the-wait")
    thread.join(timeout=5)
    assert not thread.is_alive() and result == [b"worth-the-wait"]
    assert client.get("missing", timeout_ms=100) is None
    other.close()


def test_eviction_spills_and_restores(store):
    client, *_ = store
    blobs = {f"big-{i}": bytes([i]) * (200 * 1024) for i in range(10)}
    for key, blob in blobs.items():
        client.put(key, blob)
    stats = client.stats()
    assert stats["evictions"] > 0 and stats["spilled_bytes"] > 0
    for key, blob in blobs.items():
        view = client.get(key, timeout_ms=0)
        assert view is not None and bytes(view) == blob
        client.release(key)
    assert client.stats()["restores"] > 0


def test_pins_survive_pressure_and_delete(store):
    client, *_ = store
    client.put("pinned", b"p" * (100 * 1024))
    client.pin("pinned")
    for i in range(12):
        client.put(f"filler-{i}", bytes(150 * 1024))
    assert not client.list()["pinned"]["spilled"]
    client.unpin("pinned")
    assert client.delete("pinned") and not client.contains("pinned")
    assert not client.delete("pinned")


def test_a_full_store_without_spill_refuses(tmp_path):
    sock = str(tmp_path / "s2.sock")
    shm = f"/dev/shm/raytpu_torch-test2-{os.getpid()}-{time.monotonic_ns()}"
    server = ObjectStoreServer(sock, shm, 256 * 1024, spill_dir=None)
    client = ObjectStoreClient(sock, shm, 256 * 1024)
    try:
        client.put("keep", bytes(100 * 1024))
        client.pin("keep")
        with pytest.raises(ObjectStoreFull):
            client.put("toobig", bytes(400 * 1024))
    finally:
        client.close()
        server.stop()


@pytest.fixture
def io():
    io = IoThread(name="test-torch-native")
    yield io
    io.stop()


def _server(io):
    server = RpcServer(name="echo")

    async def echo(conn, payload):
        return {"echo": payload}

    async def boom(conn, payload):
        raise RuntimeError("native-call boom")

    server.route("echo", echo)
    server.route("boom", boom)

    async def start():
        return await server.start("127.0.0.1", 0)

    return server, io.run(start())


def test_request_reply_over_the_call_table(io):
    server, port = _server(io)
    client = RpcClient(("127.0.0.1", port), name="native-cli")

    async def connect():
        await client.connect(retry=False)
        return client._engine, client._conn_id

    engine, conn = io.run(connect())
    lib = _native.load()
    replies = []
    for method, payload in ((b"echo", {"x": 41}), (b"boom", {})):
        raw = msgpack.packb(payload, use_bin_type=True)
        handle = lib.rt_call_start(engine.handle, conn, method, len(method), raw, len(raw))
        assert handle != 0
        view = _native.RtMsgView()
        assert lib.rt_call_wait(engine.handle, handle, 30000, ctypes.byref(view)) == 1
        replies.append((view.kind, ctypes.string_at(view.payload, view.plen)))
        lib.rt_msg_free(view.opaque)
    assert replies[0] == (REP, msgpack.packb({"echo": {"x": 41}}, use_bin_type=True))
    assert replies[1][0] == ERR and b"native-call boom" in replies[1][1]

    async def through_python():
        with pytest.raises(RpcError, match="native-call boom"):
            await asyncio.wait_for(client.call("boom", {}), timeout=10)
        return await asyncio.wait_for(client.call("echo", [1, b"2"]), timeout=10)

    assert io.run(through_python()) == {"echo": [1, b"2"]}
    io.run(client.close())

    async def stop():
        await server.stop()

    io.run(stop())


@pytest.mark.parametrize("n", [0, 4, 300, 70_000])
def test_the_fast_lanes_reply_encode_is_the_codecs(n):
    fl = _native.load_fastlane()
    data = bytes(range(256)) * (n // 256) + b"z" * (n % 256)
    py = wire_gen.encode_task_reply({"status": "ok", "returns": [{"kind": "inline", "data": data}]})
    assert fl.probe_reply(data) == py
    assert fl.probe_reply_scan(py) == (1, data)


def test_the_fast_lanes_scanners_read_the_codecs_bytes():
    fl = _native.load_fastlane()
    spec = {"task_id": "tsk-abc-1", "job_id": "job", "function_id": "fn-1", "name": "noop",
            "args": b"\x80\x04args", "num_returns": 1, "resources": {"CPU": 1.0, "GPU": 0.5},
            "owner": {"worker_id": "w", "address": ["h", 1]}, "runtime_env": {},
            "scheduling_strategy": None, "max_retries": 0, "retry_exceptions": False,
            "has_ref_args": False, "cross_language": False, "function_ref": "",
            "trace_ctx": None}
    raw = wire_gen.encode_task_spec(spec)
    tag, _conn, _msgid, task_id, function_id, name, args, num_returns, raw2 = fl.probe(
        b"push_task", raw)
    assert (tag, task_id, function_id, name, args, num_returns, raw2) == (
        1, "tsk-abc-1", "fn-1", "noop", b"\x80\x04args", 1, raw)
    bounced = fl.probe(b"push_task", wire_gen.encode_task_spec(dict(spec, has_ref_args=True)))
    assert bounced[0] == 3
    parts = wire_gen.make_actor_task_spec_parts(
        {"seq": 0, "task_id": "", "args": b"", "actor_id": "act-1", "method": "inc",
         "owner": {"worker_id": "w", "address": ["h", 1]}})
    spliced = fl.probe_splice(parts[0], "tsk-9", parts[1], b"AB", parts[2], 12345, parts[3])
    assert spliced == wire_gen.splice(parts, "tsk-9", b"AB", seq=12345)
    assert fl.probe(b"push_actor_task", spliced)[9] == 12345
