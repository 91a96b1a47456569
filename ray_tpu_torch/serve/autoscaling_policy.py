"""Autoscaling policy: pure math, table-testable.

The port's copy of ray_tpu's ``serve/_private/autoscaling_policy.py``:
desired = ceil(demand / target) with demand the ongoing requests plus the
weighted queued ones, smoothed and clamped to [min, max]; a scale-up or
scale-down is applied only after its delay has held continuously. A route
p99 above ``slo_p99_ms`` forces one more replica (the controller passes
the proxies' p99), and so does a KV free fraction below
``kv_headroom_min`` (the controller passes the serve-LLM decode replicas'
worst).
"""

from __future__ import annotations

import math
import time

from ray_tpu_torch.serve._common import AutoscalingConfig


def calculate_desired_num_replicas(
    config: AutoscalingConfig,
    total_ongoing_requests: float,
    current_replicas: int,
    queue_depth: float = 0.0,
    p99_ms: float | None = None,
    kv_free_frac: float | None = None,
) -> int:
    demand = total_ongoing_requests + config.queue_weight * max(0.0, queue_depth)
    if current_replicas == 0:
        # Scale from zero on any traffic.
        raw = 1 if demand > 0 else 0
    else:
        per_replica = demand / current_replicas
        error_ratio = per_replica / config.target_ongoing_requests
        factor = (config.upscale_smoothing_factor if error_ratio > 1
                  else config.downscale_smoothing_factor)
        smoothed = 1 + factor * (error_ratio - 1)
        raw = math.ceil(current_replicas * smoothed - 1e-9)
    # A breached p99 target forces at least one more replica.
    slo = config.slo_p99_ms
    if slo and p99_ms is not None and p99_ms > slo and current_replicas > 0:
        raw = max(raw, current_replicas + 1)
    # A pool out of KV headroom forces one more too.
    headroom = config.kv_headroom_min
    if (headroom is not None and kv_free_frac is not None and kv_free_frac < headroom
            and current_replicas > 0):
        raw = max(raw, current_replicas + 1)
    return max(config.min_replicas, min(config.max_replicas, raw))


class AutoscalingState:
    """Tracks the decision over time, enforcing up/downscale delays."""

    def __init__(self, config: AutoscalingConfig):
        self.config = config
        self._proposal: int | None = None
        self._proposal_since: float = 0.0

    def decide(
        self,
        total_ongoing_requests: float,
        current_replicas: int,
        now: float | None = None,
        queue_depth: float = 0.0,
        p99_ms: float | None = None,
        kv_free_frac: float | None = None,
    ) -> int:
        now = time.monotonic() if now is None else now
        desired = calculate_desired_num_replicas(
            self.config, total_ongoing_requests, current_replicas,
            queue_depth=queue_depth, p99_ms=p99_ms, kv_free_frac=kv_free_frac,
        )
        if desired == current_replicas:
            self._proposal = None
            return current_replicas
        if desired != self._proposal:
            self._proposal = desired
            self._proposal_since = now
            return current_replicas
        delay = (self.config.upscale_delay_s if desired > current_replicas
                 else self.config.downscale_delay_s)
        if now - self._proposal_since >= delay:
            self._proposal = None
            return desired
        return current_replicas
