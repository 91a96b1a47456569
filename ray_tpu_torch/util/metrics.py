"""User and library metrics: Counter, Gauge and Histogram.

The port's copy of ray_tpu's ``util/metrics.py``. Points recorded in any
process of the runtime are merged locally by series (name and tags) and
sent to the controller's KV (namespace ``metrics``) every 2 s, the whole
tick in one ``kv_multi_put``; ``collect_prometheus_text`` renders them in
Prometheus's text format with the reference's ``ray_tpu_`` names, followed
by this process's native engines, the controller's and node agents'
counters (``controller_stats``) and each node's latest telemetry sample
(``resource_summary``). A process with no runtime context
(``ray_tpu_torch.init()`` not run, or no worker) drops its points at the
flush.

The serve series (the proxy's request latency and status, the handle's
reliability events and breaker states, the replicas' occupancy gauges, the
serve-LLM engine's TTFT, TPOT, token ledger and KV blocks) and the
collective series (``record_collective_op`` from every collective op,
``record_comm_stall`` and ``set_comm_inflight`` from the comm flight
recorder's watchdog) have their callers; a gang member is a runtime actor
and flushes its points as any worker does.
"""

from __future__ import annotations

import atexit
import json
import logging
import threading
import time
from typing import Mapping, Optional, Sequence

from ray_tpu_torch._private import worker as worker_mod

_FLUSH_INTERVAL_S = 2.0
_local_lock = threading.Lock()
_pending: dict[str, dict] = {}
_flusher_started = False


def _flush_loop() -> None:
    while True:
        time.sleep(_FLUSH_INTERVAL_S)
        try:
            flush()
        except Exception:
            # Keep the daemon alive across controller blips; debug-level
            # so a permanently broken uplink is still discoverable.
            logging.getLogger(__name__).debug(
                "metrics flush failed", exc_info=True
            )


def _ensure_flusher() -> None:
    global _flusher_started
    with _local_lock:
        if not _flusher_started:
            _flusher_started = True
            threading.Thread(target=_flush_loop, daemon=True).start()
            # Final flush at interpreter exit: a short-lived worker or
            # driver whose last points landed under one flush interval
            # ago would otherwise silently drop them (the daemon flusher
            # dies mid-sleep).
            atexit.register(_flush_at_exit)


def _flush_at_exit() -> None:
    try:
        flush()
    except Exception:
        logging.getLogger(__name__).debug(
            "final metrics flush failed", exc_info=True
        )


# Uplink RPCs issued by flush() since process start — observability
# for steady-state RPC accounting (one kv_multi_put per flush interval
# regardless of traffic; serve_llm's `steady_rpc_probe` attributes
# background uplinks by RPC method name when isolating request-path
# controller calls).
flush_rpcs_total = 0


def flush() -> None:
    """Push pending metric points to the controller KV — the whole tick
    rides ONE kv_multi_put RPC, not one kv_put per series."""
    global flush_rpcs_total
    with _local_lock:
        points = dict(_pending)
        _pending.clear()
    if not points:
        return
    try:
        ctx = worker_mod.get_global_context()
    except Exception:  # no runtime context: nothing to flush to
        return
    entries = [
        {"key": key, "value": json.dumps(point).encode()}
        for key, point in points.items()
    ]
    flush_rpcs_total += 1
    ctx.io.run(
        ctx.controller.call(
            "kv_multi_put",
            {
                "namespace": "metrics",
                "entries": entries,
                "overwrite": True,
            },
        )
    )


def _record(kind: str, name: str, description: str, tags: Mapping[str, str],
            value: float, buckets: Optional[Sequence[float]] = None) -> None:
    tag_str = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
    key = f"{name}{{{tag_str}}}"
    with _local_lock:
        point = _pending.get(key)
        if point is None:
            point = {
                "kind": kind,
                "name": name,
                "description": description,
                "tags": dict(tags),
                "value": 0.0,
                "count": 0,
                "sum": 0.0,
                "buckets": list(buckets) if buckets else None,
                "bucket_counts": [0] * (len(buckets) + 1) if buckets else None,
                "ts": time.time(),
            }
            _pending[key] = point
        if kind == "counter":
            point["value"] += value
        elif kind == "gauge":
            point["value"] = value
        else:  # histogram
            point["count"] += 1
            point["sum"] += value
            for i, bound in enumerate(point["buckets"]):
                if value <= bound:
                    point["bucket_counts"][i] += 1
                    break
            else:
                point["bucket_counts"][-1] += 1
        point["ts"] = time.time()
    _ensure_flusher()


class _Metric:
    kind = ""

    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: Sequence[str] = (),
    ):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: dict[str, str] = {}

    def set_default_tags(self, tags: Mapping[str, str]) -> "_Metric":
        self._default_tags = dict(tags)
        return self

    def _tags(self, tags: Optional[Mapping[str, str]]) -> dict:
        return {**self._default_tags, **(tags or {})}


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Mapping[str, str] | None = None):
        _record("counter", self._name, self._description, self._tags(tags), value)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: Mapping[str, str] | None = None):
        _record("gauge", self._name, self._description, self._tags(tags), value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Sequence[float] = (0.01, 0.1, 1, 10),
        tag_keys: Sequence[str] = (),
    ):
        super().__init__(name, description, tag_keys)
        self._boundaries = tuple(boundaries)

    def observe(self, value: float, tags: Mapping[str, str] | None = None):
        _record(
            "histogram", self._name, self._description, self._tags(tags),
            value, self._boundaries,
        )


# ---------------------------------------------------------------------------
# Collective-layer series: every ring/xla/hierarchical op feeds a
# bytes counter + latency histogram tagged by op and backend, so comm time
# and wire volume are dashboard queries (and summarize_comm() fodder).
# ---------------------------------------------------------------------------

_collective_bytes: Counter | None = None
_collective_latency: Histogram | None = None


def record_collective_op(
    op: str, backend: str, nbytes: int, seconds: float
) -> None:
    """One completed collective op: rt_collective_bytes_total (wire bytes
    where the backend measures them, logical payload otherwise) and
    rt_collective_op_latency_s, both tagged {op, backend}."""
    global _collective_bytes, _collective_latency
    if _collective_bytes is None:
        _collective_bytes = Counter(
            "rt_collective_bytes_total",
            description="Bytes moved by collective ops",
            tag_keys=("op", "backend"),
        )
        _collective_latency = Histogram(
            "rt_collective_op_latency_s",
            description="Collective op latency (seconds)",
            boundaries=(0.001, 0.01, 0.1, 1, 10),
            tag_keys=("op", "backend"),
        )
    tags = {"op": op, "backend": backend}
    _collective_bytes.inc(max(0, int(nbytes)), tags=tags)
    _collective_latency.observe(float(seconds), tags=tags)


# ---------------------------------------------------------------------------
# Comm flight recorder series: the per-process watchdog counts
# suspected stalls and exports an in-flight gauge each tick. Gauges are
# snapshots (overwritten, never drained), so a retried metrics flush stays
# idempotent: snapshot, don't drain.
# ---------------------------------------------------------------------------

_comm_stalls: Counter | None = None
_comm_inflight: Gauge | None = None
_comm_inflight_age: Gauge | None = None


def record_comm_stall(group: str, channel: str) -> None:
    """One watchdog-suspected comm stall: rt_comm_stalls_total{group,
    channel} (channel = ``group:kind:tag-skeleton`` flight channel id)."""
    global _comm_stalls
    if _comm_stalls is None:
        _comm_stalls = Counter(
            "rt_comm_stalls_total",
            description="Comm watchdog suspected-stall events",
            tag_keys=("group", "channel"),
        )
    _comm_stalls.inc(1, tags={"group": group, "channel": channel})


def set_comm_inflight(count: int, oldest_age_s: float, identity: str) -> None:
    """Current in-flight comm ops on this process: rt_comm_inflight{worker}
    plus the age of the oldest one (the watchdog's stall candidate)."""
    global _comm_inflight, _comm_inflight_age
    if _comm_inflight is None:
        _comm_inflight = Gauge(
            "rt_comm_inflight",
            description="Comm ops currently in flight",
            tag_keys=("worker",),
        )
        _comm_inflight_age = Gauge(
            "rt_comm_inflight_oldest_age_s",
            description="Age of the oldest in-flight comm op (seconds)",
            tag_keys=("worker",),
        )
    tags = {"worker": identity}
    _comm_inflight.set(float(count), tags=tags)
    _comm_inflight_age.set(float(oldest_age_s), tags=tags)


# ---------------------------------------------------------------------------
# Serve SLO series: every proxied request feeds a per-route
# latency histogram + status counter; replicas push occupancy gauges.
# These are the Prometheus half of the flight recorder's serve view (the
# p50/p95/p99 snapshots ride the controller workload store).
# ---------------------------------------------------------------------------

_serve_latency: Histogram | None = None
_serve_requests: Counter | None = None
_serve_gauges: dict[str, Gauge] = {}

# SLO-shaped bounds: sub-5ms cache hits through multi-second tail.
SERVE_LATENCY_BOUNDARIES = (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0)


def record_serve_request(route: str, seconds: float, status: str) -> None:
    """One completed HTTP/handle request through the serve proxy:
    rt_serve_request_latency_s{route} + rt_serve_requests_total{route,
    status} where status is the HTTP class ("200", "404", "500", ...)."""
    global _serve_latency, _serve_requests
    if _serve_latency is None:
        _serve_latency = Histogram(
            "rt_serve_request_latency_s",
            description="Serve request latency through the proxy (seconds)",
            boundaries=SERVE_LATENCY_BOUNDARIES,
            tag_keys=("route",),
        )
        _serve_requests = Counter(
            "rt_serve_requests_total",
            description="Serve requests by route and status",
            tag_keys=("route", "status"),
        )
    _serve_latency.observe(float(seconds), tags={"route": route})
    _serve_requests.inc(1, tags={"route": route, "status": str(status)})


_serve_reliability_counters: dict[str, Counter] = {}

# Reliability event counters: every self-healing action on the
# serve path is countable, so "did the breaker trip / did we shed" is a
# dashboard query. Tag vocabulary is fixed per name below.
_SERVE_RELIABILITY_TAGS = {
    "retries": ("deployment", "reason"),
    "hedges": ("deployment", "outcome"),
    "shed": ("route", "where"),
    "drains": ("deployment", "trigger"),
    "stream_cancel_failures": ("deployment",),
    "proxy_restarts": ("proxy",),
    "deadline_exceeded": ("deployment",),
}


def inc_serve_reliability(name: str, n: int = 1, **tags: str) -> None:
    """Increment rt_serve_<name>_total (retries, hedges, shed, drains,
    stream_cancel_failures, proxy_restarts, deadline_exceeded)."""
    counter = _serve_reliability_counters.get(name)
    if counter is None:
        counter = _serve_reliability_counters[name] = Counter(
            f"rt_serve_{name}_total",
            description=f"Serve reliability events: {name.replace('_', ' ')}",
            tag_keys=_SERVE_RELIABILITY_TAGS.get(name, ()),
        )
    counter.inc(n, tags={k: str(v) for k, v in tags.items()})


def set_serve_breaker_state(
    deployment: str, replica_id: str, state: int
) -> None:
    """rt_serve_breaker_state{deployment,replica}: 0=closed, 1=half-open,
    2=open. A per-replica circuit breaker state transition gauge."""
    set_serve_replica_gauge("breaker_state", deployment, replica_id, state)


def set_serve_replica_gauge(
    name: str, deployment: str, replica_id: str, value: float
) -> None:
    """Replica-side occupancy gauges: rt_serve_<name>{deployment,
    replica}. Used for queue_depth, batch_occupancy, ongoing_requests."""
    gauge = _serve_gauges.get(name)
    if gauge is None:
        gauge = _serve_gauges[name] = Gauge(
            f"rt_serve_{name}",
            description=f"Serve replica {name.replace('_', ' ')}",
            tag_keys=("deployment", "replica"),
        )
    gauge.set(
        float(value), tags={"deployment": deployment, "replica": replica_id}
    )


_serve_token_hists: dict[str, Histogram] = {}
_serve_token_counter: Counter | None = None

# Token-level SLO bounds: TTFT spans queue wait + prefill +
# KV transfer + the first decode iteration (request-latency-shaped);
# TPOT is one decode iteration (orders of magnitude tighter).
SERVE_TTFT_BOUNDARIES = SERVE_LATENCY_BOUNDARIES
SERVE_TPOT_BOUNDARIES = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0,
)


def record_serve_token_latency(
    kind: str, seconds: float, deployment: str
) -> None:
    """rt_serve_ttft_s / rt_serve_tpot_s {deployment}: time-to-first-
    token and time-per-output-token of the continuous-batching decode
    path (the token-level SLO)."""
    hist = _serve_token_hists.get(kind)
    if hist is None:
        hist = _serve_token_hists[kind] = Histogram(
            f"rt_serve_{kind}_s",
            description=(
                "Time to first token (seconds)" if kind == "ttft"
                else "Time per output token (seconds)"
            ),
            boundaries=(
                SERVE_TTFT_BOUNDARIES if kind == "ttft"
                else SERVE_TPOT_BOUNDARIES
            ),
            tag_keys=("deployment",),
        )
    hist.observe(float(seconds), tags={"deployment": deployment})


def inc_serve_tokens(cls: str, n: int, deployment: str) -> None:
    """rt_serve_tokens_total{class,deployment}: the token goodput ledger
    — ``issued`` plus its exact partition into productive /
    shed / evicted / replay_discarded as sequences reach a terminal
    state."""
    global _serve_token_counter
    if n <= 0:
        return
    if _serve_token_counter is None:
        _serve_token_counter = Counter(
            "rt_serve_tokens_total",
            description="Decode tokens by ledger class",
            tag_keys=("class", "deployment"),
        )
    _serve_token_counter.inc(
        n, tags={"class": cls, "deployment": deployment}
    )


def set_serve_kv_blocks(
    deployment: str, replica_id: str, used: int, free: int
) -> None:
    """rt_serve_kv_blocks_used / rt_serve_kv_blocks_free {deployment,
    replica}: the decode replica's paged-KV pool headroom, the memory
    signal behind the serve-LLM autoscaler's kv_headroom_min floor."""
    set_serve_replica_gauge("kv_blocks_used", deployment, replica_id, used)
    set_serve_replica_gauge("kv_blocks_free", deployment, replica_id, free)


# ---------------------------------------------------------------------------
# Native/control-plane observability: the C++ engine's internal
# counters and the controller's queue depths surface as first-class
# Prometheus series, so "is the control plane draining?" is a dashboard
# query instead of a debugger session.
# ---------------------------------------------------------------------------

_CONTROLLER_GAUGES = (
    "pending_lease_shapes",
    "pending_lease_depth",
    "pending_demands",
    "pub_outbox_depth",
    "subscriber_conns",
    "mutation_cache_size",
    "nodes_alive",
)
_NODE_GAUGES = ("workers", "idle_workers", "leases", "bundles",
                "resource_waiters")


def local_engine_points() -> list:
    """(name, tags, value, kind) for every live native engine in THIS
    process (driver side; node agents report theirs via heartbeat)."""
    points: list = []
    try:
        from ray_tpu_torch._private.rpc import _NativeEngine

        with _NativeEngine._lock:
            engines = sorted(_NativeEngine._by_loop.items())
    except Exception:
        return points
    for idx, (_loop_id, engine) in enumerate(engines):
        try:
            stats = engine.stats()
        except Exception:  # the engine died mid-scrape
            continue
        for field, value in stats.items():
            points.append(
                (f"native_engine_{field}", {"engine": str(idx)},
                 float(value), "gauge")
            )
    return points


def control_plane_points(ctx) -> list:
    """(name, tags, value, kind) from the controller's live internals:
    its own counters/queue depths plus the per-node agent stats (worker
    pools + native engine counters) piggybacked on heartbeats."""
    points: list = []
    try:
        stats = ctx.io.run(
            ctx.controller.call("controller_stats", {}, timeout=5.0)
        )
    except Exception:
        return points
    for name, value in sorted((stats.get("counters") or {}).items()):
        points.append((f"controller_{name}", {}, float(value), "counter"))
    for field in _CONTROLLER_GAUGES:
        if field in stats:
            points.append(
                (f"controller_{field}", {}, float(stats[field]), "gauge")
            )
    for field, value in sorted((stats.get("snapshot") or {}).items()):
        points.append(
            (f"controller_snapshot_{field}", {}, float(value), "gauge")
        )
    for node_id, nstats in sorted((stats.get("node_stats") or {}).items()):
        for field in _NODE_GAUGES:
            if field in nstats:
                points.append(
                    (f"node_{field}", {"node": node_id},
                     float(nstats[field]), "gauge")
                )
        for field, value in sorted((nstats.get("engine") or {}).items()):
            points.append(
                (f"native_engine_{field}", {"node": node_id},
                 float(value), "gauge")
            )
    return points


# Node-sample fields exported 1:1 as per-node gauges. The
# full history stays in the controller's time-series store; /metrics
# exposes the CURRENT sample set the way Prometheus expects (it builds
# its own history by scraping).
_TELEMETRY_GAUGES = (
    "cpu_percent",
    "mem_used",
    "mem_total",
    "num_workers",
    "workers_rss_total",
    "workers_rss_max",
    "object_store_bytes",
    "object_store_capacity",
    "hbm_used",
    "hbm_total",
)


def telemetry_points(ctx) -> list:
    """(name, tags, value, kind) from each node's latest telemetry
    sample, plus per-worker RSS gauges and the oom_risk counter."""
    points: list = []
    try:
        summary = ctx.io.run(
            ctx.controller.call("resource_summary", {}, timeout=5.0)
        )
    except Exception:
        return points
    for node_id, entry in sorted((summary.get("nodes") or {}).items()):
        latest = entry.get("latest") or {}
        tags = {"node": node_id}
        for field in _TELEMETRY_GAUGES:
            if field in latest:
                points.append(
                    (f"node_{field}", tags, float(latest[field]), "gauge")
                )
        for worker_id, rss in sorted(
            (latest.get("worker_rss") or {}).items()
        ):
            points.append(
                ("worker_rss_bytes",
                 {"node": node_id, "worker": worker_id},
                 float(rss), "gauge")
            )
    points.append(
        ("oom_risk_events", {},
         float(summary.get("oom_risk_events") or 0), "counter")
    )
    return points


def _render_points(points, lines: list, seen_headers: set) -> None:
    for name, tags, value, kind in points:
        full = "ray_tpu_" + name
        if full not in seen_headers:
            seen_headers.add(full)
            lines.append(f"# HELP {full} internal {kind}")
            lines.append(f"# TYPE {full} {kind}")
        tag_str = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
        label = f"{{{tag_str}}}" if tag_str else ""
        lines.append(f"{full}{label} {value}")


def collect_prometheus_text() -> str:
    """Render every recorded metric in Prometheus exposition format."""
    try:
        ctx = worker_mod.get_global_context()
    except Exception:  # no runtime context: an empty exposition
        return ""
    keys = ctx.io.run(
        ctx.controller.call("kv_keys", {"namespace": "metrics", "prefix": ""})
    )
    lines: list[str] = []
    seen_headers: set[str] = set()
    for key in sorted(keys):
        resp = ctx.io.run(
            ctx.controller.call("kv_get", {"namespace": "metrics", "key": key})
        )
        if resp.get("status") != "ok":
            continue
        point = json.loads(resp["value"])
        name = "ray_tpu_" + point["name"]
        if name not in seen_headers:
            seen_headers.add(name)
            lines.append(f"# HELP {name} {point['description']}")
            lines.append(f"# TYPE {name} {point['kind']}")
        tag_str = ",".join(
            f'{k}="{v}"' for k, v in sorted(point["tags"].items())
        )
        label = f"{{{tag_str}}}" if tag_str else ""
        if point["kind"] == "histogram":
            cum = 0
            for bound, count in zip(
                point["buckets"], point["bucket_counts"]
            ):
                cum += count
                sep = "," if tag_str else ""
                lines.append(
                    f'{name}_bucket{{{tag_str}{sep}le="{bound}"}} {cum}'
                )
            cum += point["bucket_counts"][-1]
            sep = "," if tag_str else ""
            lines.append(f'{name}_bucket{{{tag_str}{sep}le="+Inf"}} {cum}')
            lines.append(f"{name}_count{label} {point['count']}")
            lines.append(f"{name}_sum{label} {point['sum']}")
        else:
            lines.append(f"{name}{label} {point['value']}")
    _render_points(local_engine_points(), lines, seen_headers)
    _render_points(control_plane_points(ctx), lines, seen_headers)
    _render_points(telemetry_points(ctx), lines, seen_headers)
    return "\n".join(lines) + ("\n" if lines else "")
