"""One scripted scenario of the serve plane, for either package.

``python tests/_torch_serve_scenario.py ray_tpu <port>`` (or
``ray_tpu_torch``) starts a cluster of that package and its serve with an
HTTP proxy on ``<port>``, deploys a ``@batch`` deployment with a
``user_config``, reconfigures it, calls it through a handle and through the
proxy, reads ``serve.status()``, kills a replica with the package's
``kill`` and waits for its replacement, lets a deadline expire, has a
request shed by admission, deletes the application, and reads the serve
series that ``collect_prometheus_text()`` renders; it prints one JSON
record of the outcomes on its last line. The deployments live at the top
level here: the port's replicas import this module by name (its directory
is the import root they add), the reference's receive them by value.
"""

import asyncio
import http.client
import importlib
import json
import os
import re
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PACKAGE = (sys.argv[1] if __name__ == "__main__" and len(sys.argv) > 1
           else "ray_tpu_torch")
rt = importlib.import_module(PACKAGE)
serve = importlib.import_module(f"{PACKAGE}.serve")
metrics = importlib.import_module(f"{PACKAGE}.util.metrics")
if PACKAGE == "ray_tpu":
    common = importlib.import_module("ray_tpu.serve._private.common")
    long_poll = importlib.import_module("ray_tpu.serve._private.long_poll")
else:
    common = importlib.import_module("ray_tpu_torch.serve._common")
    long_poll = importlib.import_module("ray_tpu_torch.serve.long_poll")
# Redials of a dead actor's address end in about a second (both packages
# read the same knobs).
FAST = {"rpc_retry_max_backoff_s": 0.05, "rpc_retry_max_attempts": 6}


@serve.deployment(user_config={"scale": 2}, health_check_period_s=0.5)
class Scaled:
    def __init__(self):
        self.scale = 1

    def reconfigure(self, config):
        self.scale = config["scale"]

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
    async def __call__(self, xs):
        return [x * self.scale for x in xs]


@serve.deployment(max_ongoing_requests=1, max_queued_requests=0)
class Gate:
    async def __call__(self, seconds):
        await asyncio.sleep(float(seconds))
        return seconds


def _post(port: int, path: str, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _until(predicate, timeout: float = 60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    raise TimeoutError("scenario step timed out")


def _error_name(fn) -> str:
    try:
        fn()
    except Exception as exc:  # the class is the outcome recorded
        return type(exc).__name__
    return "none"


def main(port: int) -> dict:
    out = {}
    rt.init(num_cpus=8, _system_config=FAST)
    try:
        serve.start(http_port=port)
        handle = serve.run(Scaled.bind(), name="scaled", route_prefix="/scaled")
        out["batched"] = [r.result(timeout=60) for r in [handle.remote(i) for i in range(8)]]
        handle = serve.run(Scaled.options(user_config={"scale": 3}).bind(), name="scaled",
                           route_prefix="/scaled")
        out["reconfigured"] = _until(lambda: handle.remote(1).result(timeout=60) == 3)
        out["http"] = list(_post(port, "/scaled", 5))
        status = serve.status()["scaled"]
        out["status"] = {"status": status["status"], "deployments": {
            name: [d["target_replicas"], d["running_replicas"]]
            for name, d in status["deployments"].items()}}

        # A replica killed through the package's kill is replaced.
        subscriber = long_poll.get_subscriber()
        (first,) = subscriber.get_replicas("scaled_Scaled")["actor_names"]
        rt.kill(rt.get_actor(first))
        replaced = _until(lambda: [n for n in subscriber.get_replicas("scaled_Scaled")
                                   ["actor_names"] if n != first])
        out["replaced"] = {"replicas": len(replaced),
                           "answer": handle.remote(4).result(timeout=60)}

        # A deadline that expires; a request shed by the replica's admission
        # (the proxy's router holds its one slot); the proxy's own shed.
        gate = serve.run(Gate.bind(), name="gate", route_prefix="/gate")
        token = common.set_current_deadline(common.Deadline.after(0.3))
        try:
            out["deadline"] = _error_name(lambda: gate.remote(2.0).result(timeout=60))
        finally:
            common.reset_current_deadline(token)
        # The expired call's replica is free again (its cancel landed).
        _until(lambda: _error_name(lambda: gate.remote(0).result(timeout=60)) == "none")
        held = {}
        holder = threading.Thread(target=lambda: held.update(r=_post(port, "/gate", 1.5)))
        holder.start()
        time.sleep(0.5)
        out["shed"] = _error_name(lambda: gate.remote(0).result(timeout=60))
        status_code, _ = _post(port, "/gate", 0)
        out["shed_http"] = status_code
        holder.join(60)
        out["held"] = list(held["r"])

        serve.delete("gate")
        out["deleted"] = "gate" not in serve.status()
        out["deleted_http"] = _post(port, "/gate", 0)[0]

        # The serve series every process flushed to the controller's KV.
        metrics.flush()
        time.sleep(2.5)
        text = metrics.collect_prometheus_text()
        out["series"] = sorted({m for m in re.findall(r"^# TYPE (ray_tpu_rt_serve_\w+)", text,
                                                      re.M)})
    finally:
        serve.shutdown()
        rt.shutdown()
    return out


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[2]))), flush=True)
