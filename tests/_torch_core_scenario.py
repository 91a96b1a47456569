"""One scripted scenario of the runtime's API, for either package.

``python tests/_torch_core_scenario.py ray_tpu`` (or ``ray_tpu_torch``)
starts a cluster of that package, runs tasks, actors, errors, ``wait``,
named actors and the resource tables, and prints one JSON record of the
outcomes on its last line. The accelerator key is the package's own (TPU
in the reference, GPU in the port) and is written as ``ACCEL`` in the
record, so the two records compare equal. The functions and classes live
in ``__main__``, so each package's workers receive them by value.
"""

import importlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PACKAGE = sys.argv[1] if len(sys.argv) > 1 else "ray_tpu_torch"
ACCEL = "TPU" if PACKAGE == "ray_tpu" else "GPU"
rt = importlib.import_module(PACKAGE)
# Redials of a dead actor's address end in about a second (both packages
# read the same knobs).
FAST = {"rpc_retry_max_backoff_s": 0.05, "rpc_retry_max_attempts": 6}


@rt.remote
def add(a, b):
    return a + b


@rt.remote
def sleepy(seconds, tag):
    time.sleep(seconds)
    return tag


@rt.remote
def boom():
    raise ValueError("bang")


@rt.remote(num_returns=2)
def pair(x):
    return x, -x


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.value = start

    def increment(self, by=1):
        self.value += by
        return self.value

    def fail(self):
        raise RuntimeError("actor-err")


@rt.remote
class Holder:
    def __init__(self, array):
        self.total = int(array.sum())

    def read(self):
        return self.total


def _accel(table: dict) -> dict:
    """The record's view of a resource table: CPU and the accelerator."""
    return {"CPU": table.get("CPU"), "ACCEL": table.get(ACCEL)}


def _error(fn) -> str:
    try:
        fn()
    except Exception as exc:  # the outcome is the exception's type
        return type(exc).__name__
    return "none"


def _settled(key: str, want: float) -> float:
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and rt.available_resources().get(key) != want:
        time.sleep(0.05)
    return rt.available_resources().get(key)


def main() -> dict:
    kwargs = {"num_cpus": 4, "resources": {"gate": 1}, "_system_config": FAST}
    if PACKAGE == "ray_tpu":
        kwargs["resources"]["TPU"] = 2
    else:
        kwargs["num_gpus"] = 2
    rt.init(**kwargs)
    accel_option = {"num_tpus" if PACKAGE == "ray_tpu" else "num_gpus": 1}
    record = {}
    try:
        record["chain"] = rt.get(add.remote(add.remote(1, 2), 10), timeout=60)
        record["many"] = rt.get([add.remote(i, i) for i in range(20)], timeout=60)
        record["pair"] = rt.get(list(pair.remote(5)), timeout=60)
        refs = [sleepy.remote(3.0, "slow"), sleepy.options(num_cpus=2).remote(0.0, "fast")]
        ready, not_ready = rt.wait(refs, num_returns=1, timeout=30)
        record["wait_first"] = rt.get(ready, timeout=30)
        record["wait_rest"] = len(not_ready)
        ready, not_ready = rt.wait(refs, num_returns=2, timeout=30)
        record["wait_all"] = [rt.get(r, timeout=30) for r in ready]
        record["task_error"] = _error(lambda: rt.get(boom.remote(), timeout=60))
        record["chained_error"] = _error(lambda: rt.get(add.remote(boom.remote(), 1), timeout=60))
        record["timeout"] = _error(lambda: rt.get(sleepy.remote(5, "x"), timeout=0.2))
        record["direct_call"] = _error(lambda: add(1, 2))
        record["unknown_option"] = _error(lambda: rt.remote(bogus=1)(add))

        counter = Counter.options(name="scenario-counter").remote(5)
        record["actor"] = rt.get([counter.increment.remote(i) for i in range(1, 4)], timeout=60)
        named = rt.get_actor("scenario-counter")
        record["named"] = rt.get(named.increment.remote(0), timeout=60)
        record["missing_named"] = _error(lambda: rt.get_actor("no-such-actor"))
        record["actor_error"] = _error(lambda: rt.get(counter.fail.remote(), timeout=60))
        rt.kill(counter)
        record["after_kill"] = _error(lambda: rt.get(counter.increment.remote(), timeout=60))

        # The constructor's argument by a ref held in a name, and by one that
        # nothing holds once .remote() returns (the reference frees it). The
        # orphan's creation waits for the gate, which a blocker holds until
        # .remote() has returned: else a creation scheduled while .remote()
        # still waits for the controller's reply reads the argument first.
        held = rt.put(np.ones(1000))
        record["held_constructor_ref"] = rt.get(Holder.remote(held).read.remote(), timeout=60)
        blocker = Counter.options(resources={"gate": 1}).remote()
        rt.get(blocker.increment.remote(), timeout=60)
        orphan = Holder.options(resources={"gate": 1}).remote(rt.put(np.ones(1000)))
        rt.kill(blocker)
        record["temporary_constructor_ref"] = _error(lambda: rt.get(orphan.read.remote(), timeout=3))
        rt.kill(orphan)

        total = rt.cluster_resources()
        record["total"] = _accel(total)
        holder = Counter.options(**accel_option).remote()
        rt.get(holder.increment.remote(), timeout=60)
        record["accel_held"] = _settled(ACCEL, 1.0)
        rt.kill(holder)
        record["accel_back"] = _settled(ACCEL, 2.0)
        record["nodes"] = len(rt.nodes())
    finally:
        rt.shutdown()
    return record


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    print(json.dumps(main()))
