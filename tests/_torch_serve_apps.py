"""Deployments of the port's serve plane for tests/test_torch_serve_plane.py,
test_torch_serve_multiplex.py and test_torch_serve_reliability.py.

Replicas are runtime actors that import a deployment's class by name, so
the deployments live at the top level of this module (a replica adds
tests/, the module's import root, to its path). Each mirrors one of
tests/test_serve.py's.
"""

import asyncio
import os
import time

import numpy as np
import torch

from ray_tpu_torch import serve
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve import long_poll

# The encoder's sequence length and batch buckets, as
# release/serve_bert_http.py serves its encoder (cut to the tiny model).
TINY_SEQ = 16
BUCKETS = [1, 4, 8]


def encode(bodies: list, seq: int) -> np.ndarray:
    """release/serve_bert_http.py's request layout: token ids left-aligned
    in a row of zeros."""
    tokens = np.zeros((len(bodies), seq), dtype=np.int64)
    for i, body in enumerate(bodies):
        ids = (body or {}).get("token_ids") or [101, 102]
        tokens[i, : min(len(ids), seq)] = ids[:seq]
    return tokens


@serve.deployment(max_ongoing_requests=64)
class TinyEncoder:
    """TransformerConfig.tiny() (f32) on the CPU behind @batch, answering
    logits[:, 0, :8] as float64 lists, from parameters the JAX package made."""

    def __init__(self, numpy_params: dict):
        self.config = pt.TransformerConfig.tiny()
        self.params = params_from_numpy(numpy_params, device="cpu")
        for bucket in BUCKETS:
            self._forward(np.zeros((bucket, TINY_SEQ), np.int64))

    def _forward(self, tokens: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            return pt.forward(self.params, torch.from_numpy(tokens), self.config)

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.005, bucket_sizes=BUCKETS)
    async def __call__(self, bodies):
        logits = self._forward(encode(bodies, TINY_SEQ))
        out = logits[:, 0, :8].double().numpy()
        return [{"embedding": row.tolist()} for row in out]


@serve.deployment
class Boom:
    def __call__(self, body):
        raise ValueError("boom")


@serve.deployment
class Echo:
    def __call__(self, body):
        return {"echo": body}


@serve.deployment
class TinyLogits:
    """TransformerConfig.tiny() (f32) on the CPU: a batch of token ids in,
    its whole logits out (numpy), from parameters the JAX package made."""

    def __init__(self, numpy_params: dict):
        self.config = pt.TransformerConfig.tiny()
        self.params = params_from_numpy(numpy_params, device="cpu")

    def __call__(self, tokens):
        with torch.inference_mode():
            return pt.forward(self.params, torch.from_numpy(np.asarray(tokens)),
                              self.config).numpy()


@serve.deployment
class TokenStreamer:
    """release/serve_bert_http.py's streaming deployment."""

    def __call__(self, body):
        n = int((body or {}).get("n", 8))
        for i in range(n):
            yield {"token": f"t{i}"}


@serve.deployment(num_replicas=2)
class Doubler:
    def __call__(self, x):
        return x * 2

    def pid(self, _):
        return os.getpid()


@serve.deployment
def square(x):
    return x * x


@serve.deployment
class Preprocess:
    def __call__(self, x):
        return x + 1


@serve.deployment
class Model:
    def __init__(self, pre):
        self.pre = pre

    def __call__(self, x):
        return self.pre.remote(x).result() * 10


@serve.deployment
class Calculator:
    def __init__(self, offset):
        self.offset = offset

    def add(self, x):
        return x + self.offset

    def sub(self, x):
        return x - self.offset


@serve.deployment(user_config={"threshold": 1})
class Thresholder:
    def __init__(self):
        self.threshold = 0

    def reconfigure(self, config):
        self.threshold = config["threshold"]

    def __call__(self, x):
        return x >= self.threshold

    def pid(self, _):
        return os.getpid()


@serve.deployment
class BatchedModel:
    def __init__(self):
        self.seen = []

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05, bucket_sizes=[4, 8])
    async def __call__(self, items):
        self.seen.append(len(items))
        return [i + 1000 for i in items]

    def sizes(self, _):
        return list(self.seen)


@serve.deployment(num_replicas=1, health_check_period_s=0.5)
class Fragile:
    def __call__(self, x):
        return x

    def pid(self, _):
        return os.getpid()

    def slow(self, x):
        time.sleep(1.0)
        return x


@serve.deployment
def noop(x):
    return x


@serve.deployment
class Boomer:
    def __call__(self, body):
        yield "first"
        raise ValueError("mid-stream bang")


@serve.deployment
class RouteWatcher:
    """Reads membership from inside a replica process, and calls another
    application through a handle made there."""

    def routes(self, _):
        return long_poll.get_subscriber().get_routes()

    def call(self, app_and_value):
        app, value = app_and_value
        return serve.get_deployment_handle("pong", app).remote(value).result()


@serve.deployment
def pong(x):
    return ("pong", x)


@serve.deployment(
    max_ongoing_requests=8,
    autoscaling_config=serve.AutoscalingConfig(
        min_replicas=1, max_replicas=2, target_ongoing_requests=1, upscale_delay_s=0.5,
        downscale_delay_s=1.0),
)
class Autoscaled:
    async def __call__(self, x):
        await asyncio.sleep(0.4)
        return x


@serve.deployment(ray_actor_options={"num_gpus": 0.5})
class OnHalfACard:
    def __call__(self, x):
        return x

    def visible(self, _):
        """The cards the node agent's lease let this replica see."""
        return os.environ.get("CUDA_VISIBLE_DEVICES")


@serve.deployment
class BrokenInit:
    def __init__(self):
        raise RuntimeError("constructor bang")


# -------------------------------------------------------------- multiplexing
class MuxModel:
    """A loaded model: its scale, and the calls made on it in the replica's
    event log."""

    def __init__(self, model_id: str, log: list):
        self.model_id, self.scale, self.log = model_id, int(model_id[-1]), log

    def checkpoint(self):
        self.log.append(("checkpoint", self.model_id))

    def unload(self):
        self.log.append(("unload", self.model_id))


@serve.deployment
class MultiModel:
    """tests/test_serve.py's multiplexed deployment, with its models'
    checkpoint and unload calls logged."""

    def __init__(self):
        self.log = []

    @serve.multiplexed(max_num_models_per_replica=2)
    async def get_model(self, model_id):
        self.log.append(("load", model_id))
        return MuxModel(model_id, self.log)

    async def __call__(self, x):
        model = await self.get_model(serve.get_multiplexed_model_id() or "m1")
        return x * model.scale

    async def stream(self, n):
        """A stream that runs its model while it lasts."""
        model = await self.get_model(serve.get_multiplexed_model_id())
        for i in range(n):
            await asyncio.sleep(0.05)
            yield i * model.scale

    def events(self, _):
        return list(self.log)

    def pid(self, _):
        return os.getpid()


@serve.deployment(num_replicas=2)
class MultiModelPair(MultiModel.func_or_class):
    """Two replicas of MultiModel: a model id's requests go to one."""


# --------------------------------------------------------------- reliability
@serve.deployment(num_replicas=2, retry_policy={"max_attempts": 3, "hedge": True,
                                                 "hedge_after_s": 0.2})
class Hedged:
    """Answers with its pid; the replica whose pid the body names sleeps
    first, and counts the sleeps a lost hedge cancelled."""

    def __init__(self):
        self.cancelled = 0

    async def __call__(self, body):
        if body.get("slow_pid") == os.getpid():
            try:
                await asyncio.sleep(body["sleep_s"])
            except asyncio.CancelledError:
                self.cancelled += 1
                raise
        return os.getpid()

    def cancels(self, _):
        return self.cancelled


@serve.deployment(num_replicas=2)
class Pid:
    def __call__(self, _):
        return os.getpid()


@serve.deployment(
    max_ongoing_requests=32,
    autoscaling_config=serve.AutoscalingConfig(
        min_replicas=1, max_replicas=2, target_ongoing_requests=100, upscale_delay_s=0.5,
        downscale_delay_s=600.0, slo_p99_ms=50.0),
)
class SloScaled:
    """Slower than its route's p99 target: only the p99 can add a replica."""

    async def __call__(self, x):
        await asyncio.sleep(0.1)
        return x


@serve.deployment(ray_actor_options={"resources": {"accelerator_slot": 1}, "num_tpus": 1})
class OnASlot:
    def __call__(self, x):
        return x


@serve.deployment
class Greeter:
    """tests/serve_yaml_app.py's Greeter."""

    def __init__(self):
        self.greeting = "hello"

    def reconfigure(self, config):
        self.greeting = config.get("greeting", self.greeting)

    def __call__(self, name):
        return f"{self.greeting} {name}"


greeter_app = Greeter.bind()


@serve.deployment
class GrpcEcho:
    def __call__(self, body):
        return {"grpc_echo": body}


@serve.deployment
class GrpcTokens:
    def __call__(self, body):
        yield from ["alpha", "beta", "gamma"]
