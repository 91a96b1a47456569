"""Windowed metrics aggregation for Algorithm results.

A copy of ray_tpu's ``rllib/utils/metrics.py``. Role-equivalent of rllib/utils/metrics/metrics_logger.py ::
MetricsLogger + the Stats windowing underneath (SURVEY §2.8): training
code logs raw values as they happen; `reduce()` produces the windowed
mean/min/max (plus lifetime sums and throughputs) that land in
Algorithm.train() results — instead of ad-hoc per-iteration means.
"""

from __future__ import annotations

import collections
import time
from typing import Any


class _WindowStat:
    __slots__ = ("window", "values", "lifetime_sum", "lifetime_count")

    def __init__(self, window: int):
        self.window = window
        self.values: collections.deque = collections.deque(maxlen=window)
        self.lifetime_sum = 0.0
        self.lifetime_count = 0

    def push(self, value: float) -> None:
        self.values.append(value)
        self.lifetime_sum += value
        self.lifetime_count += 1


class _Throughput:
    __slots__ = ("total", "_last_total", "_last_ts", "rate")

    def __init__(self):
        self.total = 0.0
        self._last_total = 0.0
        self._last_ts: float | None = None
        self.rate = 0.0

    def push(self, count: float) -> None:
        self.total += count

    def tick(self, now: float) -> None:
        if self._last_ts is not None and now > self._last_ts:
            self.rate = (self.total - self._last_total) / (now - self._last_ts)
        self._last_total = self.total
        self._last_ts = now


class MetricsLogger:
    """log_value / log_dict in hot paths, reduce() once per iteration.

    * ``log_value(key, v)`` — windowed stat: reduce() reports
      ``<key>_mean/_min/_max`` over the last ``window`` values.
    * ``log_value(key, v, reduce="sum")`` — lifetime counter: reduce()
      reports the running total under ``<key>``.
    * ``log_throughput(key, n)`` — counter + per-second rate between
      reduce() calls: ``<key>`` (lifetime) and ``<key>_throughput``.
    """

    def __init__(self, window: int = 100):
        self.window = window
        self._stats: dict[str, _WindowStat] = {}
        self._sums: dict[str, float] = {}
        self._throughputs: dict[str, _Throughput] = {}

    # -- logging --------------------------------------------------------
    def log_value(
        self, key: str, value: float, *, reduce: str = "window",
        window: int | None = None,
    ) -> None:
        if reduce == "sum":
            self._sums[key] = self._sums.get(key, 0.0) + float(value)
            return
        stat = self._stats.get(key)
        if stat is None:
            stat = self._stats[key] = _WindowStat(window or self.window)
        stat.push(float(value))

    def log_dict(self, values: dict, *, prefix: str = "") -> None:
        for key, value in values.items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                self.log_value(f"{prefix}{key}", value)

    def log_throughput(self, key: str, count: float) -> None:
        tp = self._throughputs.get(key)
        if tp is None:
            tp = self._throughputs[key] = _Throughput()
        tp.push(float(count))

    # -- reduction ------------------------------------------------------
    def peek(self, key: str) -> float | None:
        """Current windowed mean of ``key`` (None when nothing logged)."""
        stat = self._stats.get(key)
        if stat is None or not stat.values:
            return None
        return sum(stat.values) / len(stat.values)

    def reduce(self) -> dict[str, Any]:
        now = time.monotonic()
        out: dict[str, Any] = {}
        for key, stat in self._stats.items():
            if not stat.values:
                continue
            vals = stat.values
            out[f"{key}_mean"] = sum(vals) / len(vals)
            out[f"{key}_min"] = min(vals)
            out[f"{key}_max"] = max(vals)
        for key, total in self._sums.items():
            out[key] = total
        for key, tp in self._throughputs.items():
            tp.tick(now)
            out[key] = tp.total
            out[f"{key}_throughput"] = tp.rate
        return out

    def reset(self) -> None:
        self._stats.clear()
        self._sums.clear()
        self._throughputs.clear()
