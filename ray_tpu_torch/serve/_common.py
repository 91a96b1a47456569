"""Shared serve vocabulary: deadlines, deployment configs, replica and
request records, and the errors the serve plane raises.

The port's own copy of ray_tpu's ``serve/_private/common.py``
(``CONTROLLER_NAME``, ``Deadline`` and the current-deadline helpers,
``RetryPolicy``, ``AutoscalingConfig``, ``DeploymentConfig``,
``DeploymentInfo``, ``ReplicaInfo``, ``RequestMetadata``,
``new_replica_id``) and of ``_private/workload.py``'s ``LatencyHistogram``:
the port imports nothing of the JAX package. The serve errors are the
runtime's (``ray_tpu_torch.exceptions``), re-exported here under the names
callers use. The full-jitter retry delay is ``ray_tpu_torch.util.backoff``'s.
"""

from __future__ import annotations

import contextvars
import math
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

from ray_tpu_torch.exceptions import (  # noqa: F401  (re-exported)
    DeadlineExceededError, ReplicaDiedError, ReplicaDrainingError, RequestShedError, TaskError,
)

DEFAULT_APP_NAME = "default"

# The serve controller's detached actor, by name.
CONTROLLER_NAME = "SERVE_CONTROLLER"

# HTTP header carrying the request's remaining budget in seconds (a
# relative duration: monotonic clocks do not agree across processes, so
# each hop re-anchors it on its own clock).
DEADLINE_HEADER = "X-RayTPU-Deadline"

# gRPC metadata key carrying the same budget (lower-case, as gRPC requires).
DEADLINE_METADATA_KEY = "x-raytpu-deadline"

# Where the parts of the reference's serve plane the port has not yet
# ported are listed: the drains on the node agent's out-of-memory
# telemetry, the route stats' flush to the workload store, the CLI.
RUNTIME_CORE_ITEM = "ROADMAP Queue A item 14d"


@dataclass(frozen=True)
class Deadline:
    """A point on this process's monotonic clock by which the request must
    finish. Created once at ingress and threaded through proxy -> handle ->
    replica -> batching. ``at_monotonic`` is ``math.inf`` for unbounded
    requests."""

    at_monotonic: float = math.inf

    @classmethod
    def after(cls, budget_s: Optional[float]) -> "Deadline":
        if budget_s is None:
            return cls(math.inf)
        return cls(time.monotonic() + max(0.0, float(budget_s)))

    @classmethod
    def never(cls) -> "Deadline":
        return cls(math.inf)

    def is_unbounded(self) -> bool:
        return math.isinf(self.at_monotonic)

    def remaining(self, cap: Optional[float] = None) -> float:
        """Seconds left (>= 0); ``cap`` tightens the result."""
        left = self.at_monotonic - time.monotonic()
        if cap is not None:
            left = min(left, cap)
        return max(0.0, left)

    def expired(self) -> bool:
        return self.at_monotonic - time.monotonic() <= 0.0

    def budget(self) -> Optional[float]:
        """The remaining budget for the wire; None when unbounded. The
        receiving hop re-anchors it with ``after()``."""
        if self.is_unbounded():
            return None
        return self.remaining()


_current_deadline: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "ray_tpu_torch_serve_deadline", default=None
)


def current_deadline() -> Optional[Deadline]:
    return _current_deadline.get()


def set_current_deadline(deadline: Optional[Deadline]):
    """Sets the ambient request deadline; returns a contextvar token the
    caller hands to ``reset_current_deadline``."""
    return _current_deadline.set(deadline)


def reset_current_deadline(token) -> None:
    _current_deadline.reset(token)


@dataclass
class RetryPolicy:
    """A deployment's retry budget: attempts are spent on a replica's death
    only while the request's deadline has budget left, with full-jitter
    backoff between them. ``hedge`` launches a second attempt on another
    replica once the first has run ``hedge_after_s`` (or, unset, the
    route's observed p95) and takes whichever answers first."""

    max_attempts: int = 3
    initial_backoff_s: float = 0.02
    max_backoff_s: float = 1.0
    retry_on_timeout: bool = False
    hedge: bool = False
    hedge_after_s: Optional[float] = None

    @classmethod
    def from_dict(cls, d: dict) -> "RetryPolicy":
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**known)


@dataclass
class AutoscalingConfig:
    """Desired replicas = total ongoing (plus weighted queued) requests over
    ``target_ongoing_requests``, smoothed and clamped; applied after the
    upscale or downscale delay has held. A route p99 (scraped from the
    proxies) above ``slo_p99_ms`` asks for one more replica, and so does a
    serve-LLM decode pool whose worst replica has less than
    ``kv_headroom_min`` of its KV blocks free."""

    min_replicas: int = 1
    max_replicas: int = 10
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    upscale_smoothing_factor: float = 1.0
    downscale_smoothing_factor: float = 1.0
    metrics_interval_s: float = 1.0
    queue_weight: float = 1.0
    slo_p99_ms: Optional[float] = None
    kv_headroom_min: Optional[float] = None


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    user_config: Any = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 10.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 20.0
    ray_actor_options: dict = field(default_factory=dict)
    max_batch_queue: int = 1000
    # ``request_timeout_s`` seeds the Deadline when the caller sent none;
    # ``max_queued_requests`` is the admission allowance above
    # max_ongoing_requests (-1 derives 1x capacity, 0 queues nothing).
    request_timeout_s: float = 60.0
    health_probe_timeout_s: float = 5.0
    max_queued_requests: int = -1
    retry_policy: RetryPolicy = field(default_factory=RetryPolicy)

    def policy_snapshot(self) -> dict:
        """The subset routers and the proxy need, published with the
        membership snapshot."""
        return {
            "max_ongoing_requests": self.max_ongoing_requests,
            "request_timeout_s": self.request_timeout_s,
            "health_probe_timeout_s": self.health_probe_timeout_s,
            "max_queued_requests": self.max_queued_requests,
            "graceful_shutdown_timeout_s": self.graceful_shutdown_timeout_s,
            "retry_policy": asdict(self.retry_policy),
        }


@dataclass
class DeploymentInfo:
    name: str
    app_name: str
    config: DeploymentConfig
    cls_or_fn: Any = None
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)
    version: str = ""
    route_prefix: Optional[str] = None

    def qualified_name(self) -> str:
        return f"{self.app_name}_{self.name}"


@dataclass
class ReplicaInfo:
    replica_id: str
    deployment: str  # qualified name
    actor_name: str
    state: str = "STARTING"  # PENDING/STARTING/RUNNING/DRAINING/DEAD
    version: str = ""
    started_at: float = field(default_factory=time.time)
    node_id: str = ""


@dataclass
class RequestMetadata:
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    method_name: str = "__call__"
    multiplexed_model_id: str = ""
    session_id: str = ""
    http: bool = False
    # Remaining budget at dispatch (seconds, None = unbounded); the
    # replica re-anchors it on its own clock.
    deadline_budget_s: Optional[float] = None
    attempt: int = 0


def new_replica_id(deployment: str) -> str:
    return f"{deployment}#{uuid.uuid4().hex[:6]}"


class LatencyHistogram:
    """Fixed log-spaced latency histogram, 0.1 ms to about 54 s (ratio 1.7),
    with nearest-bucket percentiles: bounded memory for any request
    volume."""

    _BOUNDS: tuple[float, ...] = tuple(0.0001 * (1.7 ** i) for i in range(26))

    def __init__(self):
        self.counts = [0] * (len(self._BOUNDS) + 1)
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def observe(self, seconds: float) -> None:
        s = max(0.0, float(seconds))
        self.count += 1
        self.sum_s += s
        self.max_s = max(self.max_s, s)
        for i, bound in enumerate(self._BOUNDS):
            if s <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (seconds)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            cum += n
            if cum >= target and n:
                return self._BOUNDS[i] if i < len(self._BOUNDS) else self.max_s
        return self.max_s

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean_ms": 1e3 * self.sum_s / self.count if self.count else 0.0,
            "p50_ms": 1e3 * self.percentile(0.50),
            "p95_ms": 1e3 * self.percentile(0.95),
            "p99_ms": 1e3 * self.percentile(0.99),
            "max_ms": 1e3 * self.max_s,
        }
