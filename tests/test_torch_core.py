"""The port's runtime core on one host: tasks, objects and actors through
``ray_tpu_torch.init/remote/get/put/wait/cancel/kill`` on its own
controller, node agent, workers, engine and store.

The gist of the reference's ``tests/test_basic.py``, ``test_actor.py`` and
``test_cancel.py``, plus what a GPU lease adds: which cards a worker sees
(``CUDA_VISIBLE_DEVICES``), two 0.5 leases on one card, and a card's lease
coming back when its actor is killed or dies. One cluster for the module,
declared ``init(num_gpus=1)`` (this box has no card: the agent believes the
declaration, as the reference's scheduler believes ``resources={"TPU": 8}``).
The RPC redial backoff is set low through ``_system_config``, so a call to
a dead actor fails in about a second instead of the reference's 11-13 s
of redials.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import exceptions
from ray_tpu_torch._private import local_tasks

FAST = {"rpc_retry_max_backoff_s": 0.05, "rpc_retry_max_attempts": 6,
        "health_check_period_ms": 200}


@pytest.fixture(scope="module")
def cluster():
    assert not rt.is_initialized()
    info = rt.init(num_cpus=8, num_gpus=1, _system_config=FAST)
    yield info
    rt.shutdown()
    from ray_tpu_torch._private.config import reset_config

    reset_config()
    # The node's arena, /dev/shm/raytpu_torch-<agent pid>-<node suffix>,
    # went with its agent.
    suffix = info["node_id"][-8:]
    assert not [n for n in os.listdir("/dev/shm")
                if n.startswith("raytpu_torch-") and n.endswith(f"-{suffix}")]


@rt.remote
def add(a, b):
    return a + b


@rt.remote
def visible():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.value = start

    def increment(self, by=1):
        self.value += by
        return self.value

    def read(self):
        return self.value

    def pid(self):
        return os.getpid()

    def cards(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def crash(self):
        os._exit(1)

    def nap(self, seconds):
        time.sleep(seconds)
        return seconds


def _eventually(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    return predicate()


def test_init_refuses_autoscaling_naming_its_item():
    with pytest.raises(NotImplementedError, match="14d"):
        rt.init(autoscaling="v2")
    assert not rt.is_initialized()


def test_tasks_chained_refs_and_many(cluster):
    ref = add.remote(1, 2)
    assert rt.get(add.remote(ref, 10), timeout=60) == 13
    assert rt.get([add.remote(i, i) for i in range(40)], timeout=60) == [2 * i for i in range(40)]


def test_num_returns(cluster):
    @rt.remote(num_returns=3)
    def three():
        return 1, "two", [3]

    assert rt.get(list(three.remote()), timeout=60) == [1, "two", [3]]


def test_wait_gives_the_ready_in_completion_order(cluster):
    @rt.remote
    def sleepy(seconds, tag):
        time.sleep(seconds)
        return tag

    # Tasks of one shape pipeline through one leased worker; another shape
    # leases another, so the fast one finishes while the slow one sleeps.
    refs = [sleepy.remote(3.0, "slow"), sleepy.options(num_cpus=2).remote(0.0, "fast")]
    ready, not_ready = rt.wait(refs, num_returns=1, timeout=30)
    assert rt.get(ready, timeout=30) == ["fast"] and not_ready == [refs[0]]
    ready, not_ready = rt.wait(refs, num_returns=2, timeout=30)
    assert len(ready) == 2 and not not_ready
    ready, not_ready = rt.wait([sleepy.remote(5, "x")], timeout=0.2)
    assert not ready and len(not_ready) == 1


def test_cancel_running_pending_and_finished(cluster, tmp_path):
    marker = tmp_path / "started"

    @rt.remote
    def sleeper(path):
        open(path, "w").close()
        time.sleep(300)

    ref = sleeper.remote(str(marker))
    assert _eventually(marker.exists, 30)
    rt.cancel(ref)
    with pytest.raises(exceptions.TaskCancelledError):
        rt.get(ref, timeout=30)

    @rt.remote(resources={"nonexistent": 1})
    def never_runs():
        return 1

    pending = never_runs.remote()
    rt.cancel(pending)
    with pytest.raises(exceptions.TaskCancelledError):
        rt.get(pending, timeout=30)
    done = add.remote(3, 4)
    assert rt.get(done, timeout=60) == 7
    rt.cancel(done)
    assert rt.get(done, timeout=60) == 7
    with pytest.raises(ValueError):
        rt.cancel(rt.put(1))


def test_large_numpy_and_cpu_tensors_come_back_as_zero_copy_views(cluster):
    arr = np.arange(2_000_000, dtype=np.float32)
    out = rt.get(rt.put(arr), timeout=60)
    np.testing.assert_array_equal(out, arr)
    assert not out.flags.writeable
    for dtype in (torch.float32, torch.bfloat16):
        tensor = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 1024), np.float32)).to(dtype)
        ref = rt.put(tensor)
        first, second = rt.get(ref, timeout=60), rt.get(ref, timeout=60)
        assert first.dtype == dtype and torch.equal(first, tensor)
        # Two gets of one object are views of the same arena bytes.
        assert first.data_ptr() == second.data_ptr() != tensor.data_ptr()
    # A tensor a task returns, and one passed to a task by ref.
    doubled = rt.get(add.remote(rt.put(tensor), tensor), timeout=60)
    assert torch.equal(doubled, tensor + tensor)


def test_a_cuda_tensor_sent_to_a_process_without_a_card_raises(cluster):
    from ray_tpu_torch._private import serialization

    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serialization._rebuild_cuda_tensor(np.zeros(4, np.float32), None, False)


def test_task_error_carries_the_workers_traceback(cluster):
    @rt.remote
    def boom():
        def inner_frame():
            raise ValueError("bang")

        inner_frame()

    with pytest.raises(exceptions.TaskError, match="bang") as info:
        rt.get(boom.remote(), timeout=60)
    assert "inner_frame" in str(info.value)
    with pytest.raises(exceptions.TaskError):
        rt.get(add.remote(boom.remote(), 1), timeout=60)


def test_direct_calls_and_unknown_options_are_refused(cluster):
    with pytest.raises(TypeError, match="remote"):
        add(1, 2)
    with pytest.raises(TypeError, match="remote"):
        Counter()
    with pytest.raises(TypeError, match="unknown @remote options"):
        rt.remote(num_tpus=1)(lambda: None)
    with pytest.raises(TypeError, match="keyword options only"):
        rt.remote(1, 2)


def test_local_task_refs_are_refused_by_the_runtime(cluster):
    foreign = local_tasks.ObjectRef.__new__(local_tasks.ObjectRef)
    with pytest.raises(TypeError, match="14b-ii"):
        rt.get(foreign, timeout=5)
    with pytest.raises(TypeError, match="14b-ii"):
        rt.wait([foreign], timeout=5)
    with pytest.raises(TypeError, match="14b-ii"):
        local_tasks.get(rt.put(1), timeout=5)


def test_actors_named_ordered_and_killed(cluster):
    counter = Counter.options(name="core-counter").remote(5)
    assert rt.get([counter.increment.remote(i) for i in range(1, 6)], timeout=60) == [
        5 + sum(range(1, k + 1)) for k in range(1, 6)]
    same = rt.get_actor("core-counter")
    assert rt.get(same.read.remote(), timeout=60) == 20
    with pytest.raises(ValueError):
        rt.get_actor("no-such-actor")

    @rt.remote
    def bump(handle):
        return rt.get(handle.increment.remote(), timeout=30)

    assert rt.get(bump.remote(counter), timeout=60) == 21
    rt.kill(counter)
    with pytest.raises((exceptions.ActorDiedError, exceptions.ActorUnavailableError)):
        rt.get(counter.read.remote(), timeout=60)


def test_a_wait_cancelled_on_a_loop_leaves_the_loop_running(cluster):
    """A call awaited on an event loop (``get_on_loop``, as a serve
    handle's attempt is) and cancelled there, as a hedge's loser is, drops
    its ref while the engine's wait for the reply still runs on a settle
    thread. The loop goes on at once: before, the drop waited on the loop
    for that wait's lock, until the reply (or a dead replica's lost
    connection), and every request on the loop with it."""
    import asyncio
    import concurrent.futures

    from ray_tpu_torch._private import worker

    counter = Counter.remote()
    # Started, and its direct connection made (the lane the settle drives).
    assert rt.get([counter.nap.remote(0) for _ in range(3)], timeout=60) == [0, 0, 0]
    ctx = worker.get_global_context()
    settle_threads = concurrent.futures.ThreadPoolExecutor(2)

    async def cancel_a_slow_call() -> float:
        async def call():
            return await ctx.get_on_loop(counter.nap.remote(2.0), settle_threads)

        task = asyncio.ensure_future(call())
        await asyncio.sleep(0.2)
        task.cancel()
        t0 = time.monotonic()
        with pytest.raises(asyncio.CancelledError):
            await task
        await asyncio.sleep(0.05)
        return time.monotonic() - t0

    try:
        assert asyncio.run(cancel_a_slow_call()) < 1.0
        # The call still ran to its end, and the actor goes on answering.
        assert rt.get(counter.nap.remote(0), timeout=60) == 0
    finally:
        settle_threads.shutdown(wait=True)
        rt.kill(counter)


def test_max_restarts_then_actor_died(cluster):
    actor = Counter.options(max_restarts=1).remote(3)
    first = rt.get(actor.pid.remote(), timeout=60)
    with pytest.raises((exceptions.ActorDiedError, exceptions.WorkerCrashedError,
                        exceptions.ActorUnavailableError, exceptions.TaskError)):
        rt.get(actor.crash.remote(), timeout=60)

    def answers():
        try:
            return rt.get(actor.pid.remote(), timeout=30)
        except (exceptions.ActorDiedError, exceptions.ActorUnavailableError):
            return None

    second = _eventually(answers, 60)
    assert second and second != first
    assert rt.get(actor.read.remote(), timeout=30) == 3  # state starts over
    with pytest.raises((exceptions.ActorDiedError, exceptions.WorkerCrashedError,
                        exceptions.ActorUnavailableError, exceptions.TaskError)):
        rt.get(actor.crash.remote(), timeout=60)
    with pytest.raises(exceptions.ActorDiedError):
        rt.get(actor.read.remote(), timeout=60)


def test_worker_stdout_reaches_the_driver_with_its_pid(cluster, capsys):
    # The driver's log thread prints to sys.stdout (capsys); fd-level
    # capture would race that thread's buffered writes.
    @rt.remote
    def speak():
        print("hello from a worker", flush=True)
        return os.getpid()

    pid = rt.get(speak.remote(), timeout=60)
    seen = ""

    def printed():
        nonlocal seen
        seen += capsys.readouterr().out
        return f"(pid={pid}) hello from a worker" in seen

    assert _eventually(printed, 10), seen


def test_nodes_and_declared_resources(cluster):
    (node,) = rt.nodes()
    assert node["alive"] and node["node_id"] == cluster["node_id"]
    total = rt.cluster_resources()
    assert total["GPU"] == 1.0 and total["CPU"] == 8.0
    assert _eventually(lambda: rt.available_resources().get("GPU") == 1.0)


def test_a_cpu_worker_sees_no_card_and_a_gpu_lease_sees_its_card(cluster):
    assert rt.get(visible.remote(), timeout=60) == ""
    assert rt.get(visible.options(num_gpus=1).remote(), timeout=60) == "0"


def test_two_half_leases_share_the_card_at_once(cluster, tmp_path):
    @rt.remote(num_gpus=0.5)
    def half(path, peer):
        open(path, "w").close()
        deadline = time.monotonic() + 30
        while not os.path.exists(peer) and time.monotonic() < deadline:
            time.sleep(0.01)
        return os.environ.get("CUDA_VISIBLE_DEVICES"), os.path.exists(peer)

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    # Each waits for the other to start: both hold a lease at once. (Tasks
    # of one shape pipeline through one leased worker, as the reference's
    # dispatcher does below a depth of 4, so the two differ in CPUs.)
    refs = [half.remote(a, b), half.options(num_cpus=2).remote(b, a)]
    assert rt.get(refs, timeout=60) == [("0", True)] * 2
    assert _eventually(lambda: rt.available_resources().get("GPU") == 1.0)


def test_a_killed_or_dead_gpu_actors_lease_comes_back(cluster):
    holder = Counter.options(num_gpus=1).remote()
    assert rt.get(holder.cards.remote(), timeout=60) == "0"
    assert rt.available_resources().get("GPU") == 0.0
    rt.kill(holder)
    assert _eventually(lambda: rt.available_resources().get("GPU") == 1.0)
    dying = Counter.options(num_gpus=1).remote()
    assert rt.get(dying.cards.remote(), timeout=60) == "0"
    with pytest.raises((exceptions.ActorDiedError, exceptions.WorkerCrashedError,
                        exceptions.ActorUnavailableError, exceptions.TaskError)):
        rt.get(dying.crash.remote(), timeout=60)
    assert _eventually(lambda: rt.available_resources().get("GPU") == 1.0)


def test_runtime_env_env_vars_working_dir_and_py_modules(cluster, tmp_path):
    work = tmp_path / "work"
    work.mkdir()
    (work / "data.txt").write_text("from the working dir")
    mods = tmp_path / "mods" / "port_env_helper"
    mods.mkdir(parents=True)
    (mods / "__init__.py").write_text("VALUE = 41\n")

    @rt.remote(runtime_env={"env_vars": {"PORT_ENV_MARKER": "42"},
                            "working_dir": str(work), "py_modules": [str(mods)]})
    def read_env():
        import port_env_helper

        with open("data.txt") as fh:
            return os.environ.get("PORT_ENV_MARKER"), fh.read(), port_env_helper.VALUE + 1

    assert rt.get(read_env.remote(), timeout=60) == ("42", "from the working dir", 42)


def test_runtime_api_beyond_this_slice_raises_naming_its_item(cluster):
    with pytest.raises(NotImplementedError, match="14b-ii"):
        rt.timeline()
    with pytest.raises(RuntimeError, match="twice"):
        rt.init()


class _Smi:
    """nvidia-smi's answer for two cards of a host."""

    stdout = ("0, NVIDIA H100 80GB HBM3, GPU-aaaa\n"
              "1, NVIDIA H100 80GB HBM3, GPU-bbbb\n")
    returncode = 0


@pytest.mark.parametrize("visible, want", [
    (None, ["0", "1"]), ("1", ["1"]), ("GPU-bbbb,0", ["1", "0"]), ("", []), ("7", [])])
def test_the_agent_counts_the_visible_cards_without_opening_one(monkeypatch, visible, want):
    import shutil
    import subprocess

    from ray_tpu_torch._private import node_agent

    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/" + name)
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(cmd) or _Smi())
    cards = node_agent.visible_gpus()
    assert [index for index, _ in cards] == want
    assert node_agent.detect_gpu_resources(cards) == (
        {"GPU": float(len(want)), "GPU-NVIDIA-H100-80GB-HBM3": float(len(want))} if want else {})
    # The probe is one nvidia-smi query (none when the variable is empty),
    # never torch: the agent opens no context on a card.
    assert calls == ([] if visible == "" else [
        ["/usr/bin/nvidia-smi", "--query-gpu=index,name,uuid", "--format=csv,noheader"]])


def test_leases_take_cards_by_share():
    from ray_tpu_torch._private.node_agent import NodeAgent

    agent = NodeAgent.__new__(NodeAgent)
    agent._card_free = {"0": 1.0, "1": 1.0}
    halves = [agent._take_cards({"GPU": 0.5}) for _ in range(2)]
    assert halves == ["0", "0"]  # the busiest card that still fits
    assert agent._take_cards({"GPU": 1}) == "1"
    assert agent._take_cards({"GPU": 0.5}) is None and agent._take_cards({"CPU": 1}) == ""
    agent._release_cards("0", {"GPU": 0.5})
    agent._release_cards("1", {"GPU": 1})
    assert agent._take_cards({"GPU": 2}) is None and agent._card_free == {"0": 0.5, "1": 1.0}
    agent._release_cards("0", {"GPU": 0.5})
    assert agent._take_cards({"GPU": 2}) == "0,1"
