"""Cluster resource-telemetry store.

The node agents sample CPU / RSS / object-store / HBM once per
``telemetry_sample_interval_s`` and piggyback the samples on the
heartbeat payload (the stats channel).  The controller lands them here:
a per-node, bounded, tiered ring buffer with time-based downsampling so
a multi-hour run stays O(MB) —

    raw   : every sample as shipped          (default 360  ≈ 6 min @1s)
    10s   : one bucket per 10 s of samples   (default 360  ≈ 1 h)
    60s   : one bucket per 60 s of samples   (default 1440 ≈ 24 h)

Buckets aggregate **mean** for rate-like gauges (cpu_percent) and
**max** for footprint gauges (rss, mem_used, object-store bytes, hbm):
for capacity planning the peak within a bucket is the signal; averaging
it away would hide short spikes that matter for OOM forensics.

The store is deliberately dependency-free and single-threaded from the
controller's perspective (all mutation happens on the controller's
asyncio thread via rpc_heartbeat), so there are no locks.  Chaos safety:
heartbeats can be duplicated or replayed by the fault layer, so ``add``
drops any sample whose timestamp is not strictly newer than the last one
seen for that node — the series stays monotonic under dup/replay and
bounded under flood.

``project_rss`` is the trend half of the memory monitor's early warning
(satellite of the same PR): a least-squares slope over the recent
(t, rss) history, used by the node agent to emit ``oom_risk`` before the
point-in-time kill threshold fires.

``hbm_stats`` is the port's counterpart of ``NodeAgent._hbm_stats``: card
memory of a process that has already initialised CUDA, never forcing an
init (the reference's agent never imports jax itself).
"""

from __future__ import annotations

import collections
from typing import Any, Iterable

# Fields aggregated with max() inside a downsampling bucket; everything
# else numeric is averaged. Footprints peak, rates average.
_MAX_FIELDS = frozenset(
    {
        "mem_used",
        "mem_total",
        "object_store_bytes",
        "object_store_capacity",
        "hbm_used",
        "hbm_total",
        "workers_rss_total",
        "workers_rss_max",
        "num_workers",
    }
)

# Tier name -> bucket width in seconds. "raw" is width 0 (no bucketing).
TIERS: tuple[tuple[str, float], ...] = (("raw", 0.0), ("10s", 10.0), ("60s", 60.0))


def _aggregate(samples: list[dict[str, Any]]) -> dict[str, Any]:
    """Fold a bucket's raw samples into one aggregate sample."""
    if len(samples) == 1:
        return dict(samples[0])
    out: dict[str, Any] = {}
    keys: set[str] = set()
    for s in samples:
        keys.update(s)
    for key in keys:
        vals = [s[key] for s in samples if key in s]
        if key == "ts":
            out["ts"] = max(vals)
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in vals):
            if key in _MAX_FIELDS:
                out[key] = max(vals)
            else:
                out[key] = sum(vals) / len(vals)
        else:
            out[key] = vals[-1]  # non-numeric (e.g. per-worker map): latest wins
    out["samples"] = sum(int(s.get("samples", 1)) for s in samples)
    return out


class _NodeSeries:
    """All retention tiers for one node."""

    def __init__(self, capacities: dict[str, int]):
        self.rings: dict[str, collections.deque] = {
            name: collections.deque(maxlen=max(1, int(capacities.get(name, 1))))
            for name, _width in TIERS
        }
        # Per-tier open bucket: (bucket_start_epoch, [samples...]).
        self._open: dict[str, tuple[float, list[dict[str, Any]]]] = {}
        self.last_ts: float = 0.0
        self.dropped: int = 0  # non-monotonic (dup/replayed) samples

    def add(self, sample: dict[str, Any]) -> bool:
        ts = sample.get("ts")
        if not isinstance(ts, (int, float)):
            self.dropped += 1
            return False
        if ts <= self.last_ts:  # dup / replay / clock step back: drop
            self.dropped += 1
            return False
        self.last_ts = float(ts)
        self.rings["raw"].append(sample)
        for name, width in TIERS:
            if width <= 0:
                continue
            bucket_start = int(ts // width) * width
            open_bucket = self._open.get(name)
            if open_bucket is None:
                self._open[name] = (bucket_start, [sample])
                continue
            start, pending = open_bucket
            if bucket_start == start:
                pending.append(sample)
            else:
                agg = _aggregate(pending)
                agg["bucket_start"] = start
                agg["bucket_s"] = width
                self.rings[name].append(agg)
                self._open[name] = (bucket_start, [sample])
        return True

    def timeline(self, tier: str | None = None) -> dict[str, list[dict[str, Any]]]:
        """Closed buckets plus a live aggregate of the open bucket, so
        callers (dashboard, `top`) see fresh data without waiting a full
        bucket width."""
        names = [tier] if tier else [name for name, _w in TIERS]
        out: dict[str, list[dict[str, Any]]] = {}
        for name in names:
            if name not in self.rings:
                continue
            points = list(self.rings[name])
            open_bucket = self._open.get(name)
            if open_bucket is not None:
                start, pending = open_bucket
                agg = _aggregate(pending)
                agg["bucket_start"] = start
                agg["partial"] = True
                points.append(agg)
            out[name] = points
        return out

    def latest(self) -> dict[str, Any] | None:
        return self.rings["raw"][-1] if self.rings["raw"] else None


class TelemetryStore:
    """Bounded per-node time-series store living on the controller."""

    def __init__(
        self,
        raw_capacity: int = 360,
        cap_10s: int = 360,
        cap_60s: int = 1440,
        max_nodes: int = 1024,
        max_workload_series: int = 4096,
    ):
        self._caps = {"raw": raw_capacity, "10s": cap_10s, "60s": cap_60s}
        self._max_nodes = max_nodes
        self._nodes: dict[str, _NodeSeries] = {}
        self.total_ingested = 0
        self.total_dropped = 0
        # Workload flight-recorder series: same tiered rings +
        # monotonic guard, keyed by series name instead of node id
        # ("train/<exp>", "train/<exp>/rank<k>", "train/<exp>/goodput",
        # "serve/<route>").
        self._max_workload_series = max_workload_series
        self._workloads: dict[str, _NodeSeries] = {}
        self.workload_ingested = 0
        self.workload_dropped = 0

    def add(self, node_id: str, sample: dict[str, Any]) -> bool:
        series = self._nodes.get(node_id)
        if series is None:
            if len(self._nodes) >= self._max_nodes:
                self.total_dropped += 1
                return False
            series = self._nodes[node_id] = _NodeSeries(self._caps)
        ok = series.add(sample)
        if ok:
            self.total_ingested += 1
        else:
            self.total_dropped += 1
        return ok

    def add_many(self, node_id: str, samples: Iterable[dict[str, Any]]) -> int:
        return sum(1 for s in samples if self.add(node_id, s))

    def forget(self, node_id: str) -> None:
        self._nodes.pop(node_id, None)

    def node_ids(self) -> list[str]:
        return sorted(self._nodes)

    def timeline(self, node_id: str, tier: str | None = None) -> dict[str, list]:
        series = self._nodes.get(node_id)
        return series.timeline(tier) if series else {}

    def summary(self) -> dict[str, Any]:
        """Per-node latest sample + series lengths — the payload behind
        ``util/state.summarize_resources()`` and ``ray_tpu_torch top``."""
        nodes: dict[str, Any] = {}
        for node_id, series in self._nodes.items():
            nodes[node_id] = {
                "latest": series.latest(),
                "points": {name: len(ring) for name, ring in series.rings.items()},
                "last_ts": series.last_ts,
                "dropped": series.dropped,
            }
        return {
            "nodes": nodes,
            "total_ingested": self.total_ingested,
            "total_dropped": self.total_dropped,
        }

    # -- workload series --------------------------------------
    def add_workload(self, key: str, sample: dict[str, Any]) -> bool:
        """One flight-recorder sample for series ``key``. Same chaos
        rules as node samples: the ts monotonic guard drops duplicated or
        replayed batches, so a re-delivered round can never double-count
        a step."""
        if not isinstance(key, str) or not key or not isinstance(sample, dict):
            self.workload_dropped += 1
            return False
        series = self._workloads.get(key)
        if series is None:
            if len(self._workloads) >= self._max_workload_series:
                self.workload_dropped += 1
                return False
            series = self._workloads[key] = _NodeSeries(self._caps)
        ok = series.add(sample)
        if ok:
            self.workload_ingested += 1
        else:
            self.workload_dropped += 1
        return ok

    def add_workload_many(
        self, key: str, samples: Iterable[dict[str, Any]]
    ) -> int:
        return sum(1 for s in samples if self.add_workload(key, s))

    def workload_keys(self) -> list[str]:
        return sorted(self._workloads)

    def workload_timeline(
        self, key: str, tier: str | None = None
    ) -> dict[str, list]:
        series = self._workloads.get(key)
        return series.timeline(tier) if series else {}

    def workload_summary(self) -> dict[str, Any]:
        """Per-series latest sample + tier depths — behind
        ``util.state.summarize_workload()`` and ``/api/workload``."""
        series_out: dict[str, Any] = {}
        for key, series in self._workloads.items():
            series_out[key] = {
                "latest": series.latest(),
                "points": {name: len(ring) for name, ring in series.rings.items()},
                "last_ts": series.last_ts,
                "dropped": series.dropped,
            }
        return {
            "series": series_out,
            "total_ingested": self.workload_ingested,
            "total_dropped": self.workload_dropped,
        }

    def stats(self) -> dict[str, int]:
        """Bound-check counters for controller_stats / tests."""
        points = sum(
            len(ring) for s in self._nodes.values() for ring in s.rings.values()
        )
        workload_points = sum(
            len(ring)
            for s in self._workloads.values()
            for ring in s.rings.values()
        )
        return {
            "telemetry_nodes": len(self._nodes),
            "telemetry_points": points,
            "telemetry_ingested": self.total_ingested,
            "telemetry_dropped": self.total_dropped,
            "workload_series": len(self._workloads),
            "workload_points": workload_points,
            "workload_ingested": self.workload_ingested,
            "workload_dropped": self.workload_dropped,
        }


def project_rss(
    history: Iterable[tuple[float, float]], horizon_s: float
) -> float | None:
    """Least-squares RSS projection ``horizon_s`` seconds past the last
    observation.  Returns None when there are <3 points or no time
    spread (a slope from two points is all noise at 1 Hz sampling).

    Used by the node agent's memory monitor: when the projection crosses
    the kill limit while the current RSS is still under it, the worker is
    *trending* toward OOM and an ``oom_risk`` event fires — the early
    warning that a point-in-time threshold can never give.
    """
    pts = [(float(t), float(v)) for t, v in history]
    if len(pts) < 3:
        return None
    t_last = pts[-1][0]
    span = t_last - pts[0][0]
    if span <= 0:
        return None
    n = len(pts)
    mean_t = sum(t for t, _ in pts) / n
    mean_v = sum(v for _, v in pts) / n
    var_t = sum((t - mean_t) ** 2 for t, _ in pts)
    if var_t <= 0:
        return None
    slope = sum((t - mean_t) * (v - mean_v) for t, v in pts) / var_t
    return pts[-1][1] + slope * float(horizon_s)


def hbm_stats(device=None) -> dict:
    """``{"hbm_used", "hbm_total"}`` in bytes from ``torch.cuda.mem_get_info``
    of the process's card: ``device``, or the current device (a gang member
    drives one card, and probing the others would open a context on each).
    Used is what the whole card has in use, every process on it included.
    ``{}`` when the process has not initialised CUDA: telemetry never forces
    a CUDA init, as the reference's agent never imports jax itself."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    index = torch.cuda.current_device() if device is None else torch.device(device).index or 0
    free, total = torch.cuda.mem_get_info(index)
    if not total:
        return {}
    return {"hbm_used": int(total - free), "hbm_total": int(total)}
