"""Runtime flag system.

The port's copy of ray_tpu's ``_private/config.py``: one place defining
the runtime's knobs, each overridable per process through the environment as
``RAY_TPU_<name>`` (read when this module is imported), and a process takes
those of the ``_system_config`` its parent's runtime passes it through
``RAYTPU_SYSTEM_CONFIG`` (a JSON object). The reference's
``tpu_slice_override`` has no GPU meaning and is not kept: ``init(num_gpus=,
resources=)`` declares cards, and the knobs no ported module reads (the
reference's ``object_store_memory``, ``worker_pool_prestart`` and a few
more) are left out. Library-level
configs (ScalingConfig etc.) live with their libraries; this file is the
*runtime* tier.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


def _env(name: str, default: Any) -> Any:
    raw = os.environ.get(f"RAY_TPU_{name}")
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclasses.dataclass
class RayTpuConfig:
    """All core-runtime knobs. Mirrors ray_config_def.h's role."""

    # --- object plane ---
    # Objects below this size are inlined in RPC replies and live in the
    # owner's in-process memory store (reference:
    # ray_config_def.h :: max_direct_call_object_size ~100KiB).
    max_direct_call_object_size: int = _env("max_direct_call_object_size", 100 * 1024)
    # Chunk size for inter-node object transfer (reference ~5MiB chunks).
    object_transfer_chunk_bytes: int = _env(
        "object_transfer_chunk_bytes", 5 * 1024 * 1024
    )
    # Push-based transfer (push_manager.cc role): owners proactively push
    # large task args toward the consumer's node at submit time; pull
    # stays the fallback. 0 disables.
    push_transfers_enabled: int = _env("push_transfers_enabled", 1)
    push_transfer_min_bytes: int = _env(
        "push_transfer_min_bytes", 1024 * 1024
    )
    # Native lease lane (raylet grant path in C++, N9/N10): the agent's
    # engine grants simple worker leases on its own thread. 0 disables
    # (all leases take the asyncio handler).
    native_lease_lane: int = _env("native_lease_lane", 1)

    # --- health / liveness (reference: health_check_* in ray_config_def.h) ---
    health_check_period_ms: int = _env("health_check_period_ms", 1000)
    health_check_timeout_ms: int = _env("health_check_timeout_ms", 5000)
    health_check_failure_threshold: int = _env("health_check_failure_threshold", 5)

    # --- scheduling ---
    # Above this utilization fraction the hybrid policy stops packing and
    # spreads (reference: scheduler_spread_threshold 0.5).
    scheduler_spread_threshold: float = _env("scheduler_spread_threshold", 0.5)
    worker_register_timeout_s: float = _env("worker_register_timeout_s", 60.0)
    # How long a caller waits for a PENDING/RESTARTING actor to come up
    # before failing the call (reference: wait_for_death_info + lease
    # backoff behaviour).
    actor_ready_timeout_s: float = _env("actor_ready_timeout_s", 150.0)

    # How long a task dispatcher keeps its worker lease warm after its
    # queue drains, waiting for the next same-shape task (reference:
    # normal_task_submitter lease reuse + raylet idle lease grace). Without
    # this every back-to-back sync task pays the full 3-RPC lease chain
    # (controller request_lease + agent lease_worker + dial).
    worker_lease_grace_s: float = _env("worker_lease_grace_s", 0.25)
    # In-flight tasks a dispatcher pipelines through one leased worker
    # before awaiting replies (reference: normal_task_submitter pipelining).
    # Amortizes per-task wakeups/syscalls; 1 = strict request-reply.
    worker_pipeline_depth: int = _env("worker_pipeline_depth", 4)

    # Direct-call lane: simple tasks/actor calls ride the native C++ call
    # table from the caller thread (no asyncio on the hot path —
    # reference: normal_task_submitter.cc direct calls [N19]). Set
    # RAY_TPU_direct_call=0 to force everything through the asyncio path.
    direct_call: bool = _env("direct_call", True)

    # --- memory monitor (reference: memory_monitor.cc + raylet OOM
    # killer, RAY_memory_usage_threshold / RAY_memory_monitor_refresh_ms) ---
    memory_monitor_interval_s: float = _env("memory_monitor_interval_s", 0.25)
    # Node-level usage fraction past which the largest-RSS worker is killed.
    memory_usage_threshold: float = _env("memory_usage_threshold", 0.95)
    # Absolute per-worker RSS cap in MiB (0 = disabled); any worker above
    # it is killed regardless of node usage — also the testing knob.
    memory_worker_rss_limit_mb: int = _env("memory_worker_rss_limit_mb", 0)

    # --- tasks / fault tolerance ---
    task_max_retries_default: int = _env("task_max_retries_default", 3)
    lineage_pinning_enabled: bool = _env("lineage_pinning_enabled", True)

    # --- task events / state API (reference: RAY_task_events_max_num_*) ---
    task_events_max_buffer: int = _env("task_events_max_buffer", 10000)

    # --- control-plane persistence (reference: redis_store_client [N7]) ---
    controller_snapshot_period_s: float = _env("controller_snapshot_period_s", 0.5)
    # Snapshot backend: "file" (session dir), "memory", or
    # "kv://host:port" (external wire-v1 KV — survives head-disk loss).
    controller_store: str = _env("controller_store", "file")

    # --- pubsub / rpc ---
    rpc_retry_initial_backoff_s: float = _env("rpc_retry_initial_backoff_s", 0.1)
    rpc_retry_max_backoff_s: float = _env("rpc_retry_max_backoff_s", 5.0)
    rpc_retry_max_attempts: int = _env("rpc_retry_max_attempts", 10)

    # --- testing / chaos (reference: RAY_testing_asio_delay_us) ---
    # DEPRECATED alias: kept for compatibility, now interpreted by
    # ray_tpu_torch._private.chaos as a delay-only FaultSchedule applied
    # client-side in both RPC backends. Prefer RAY_TPU_chaos (JSON
    # FaultSchedule) / ray_tpu_torch.util.chaos for anything richer.
    testing_rpc_delay_ms: int = _env("testing_rpc_delay_ms", 0)

    # --- runtime envs (reference: _private/runtime_env/* agent knobs) ---
    # Extra args appended to every `pip install` a node agent runs while
    # materializing a pip runtime env (e.g. "--no-index --find-links /wheels"
    # for airgapped clusters).
    runtime_env_pip_extra_args: str = _env("runtime_env_pip_extra_args", "")
    # Total bytes of unreferenced materialized envs kept cached per node
    # before LRU deletion (reference: RAY_RUNTIME_ENV_*_CACHE_SIZE_GB).
    runtime_env_cache_size_mb: int = _env("runtime_env_cache_size_mb", 2048)
    runtime_env_setup_timeout_s: float = _env(
        "runtime_env_setup_timeout_s", 600.0
    )

    # --- tracing (reference: RAY_TRACING_ENABLED / OTel hook, SURVEY §5.1) ---
    tracing_enabled: bool = _env("tracing_enabled", False)

    # --- resource telemetry (reference: raylet stats + dashboard
    # node_head time-series; Podracer-style sustained-utilization view) ---
    # Master switch for the per-node sampler + controller time-series
    # store. Cheap enough to ship on by default (one psutil sweep per
    # sample interval, piggybacked on the existing heartbeat).
    telemetry_enabled: bool = _env("telemetry_enabled", True)
    # Seconds between node samples. The memory-monitor loop (which runs
    # every memory_monitor_interval_s) assembles a telemetry sample at
    # most this often.
    telemetry_sample_interval_s: float = _env("telemetry_sample_interval_s", 1.0)
    # Ring sizes for the controller store's retention tiers:
    # raw samples (~1 per sample interval), 10s buckets, 60s buckets.
    # Defaults: ~6 min raw + 1 h of 10s + 24 h of 60s per node, all O(MB).
    telemetry_raw_capacity: int = _env("telemetry_raw_capacity", 360)
    telemetry_10s_capacity: int = _env("telemetry_10s_capacity", 360)
    telemetry_60s_capacity: int = _env("telemetry_60s_capacity", 1440)
    # Trend-aware OOM early warning: emit an ``oom_risk`` event when a
    # worker's RSS slope projects past the kill limit within this horizon
    # (seconds). 0 disables projection.
    oom_risk_horizon_s: float = _env("oom_risk_horizon_s", 10.0)
    # Minimum seconds between oom_risk events for the same worker.
    oom_risk_cooldown_s: float = _env("oom_risk_cooldown_s", 30.0)

    # --- event export (reference: RayEvent export files, N28) ---
    event_export_enabled: bool = _env("event_export_enabled", True)
    event_export_max_bytes: int = _env(
        "event_export_max_bytes", 16 * 1024 * 1024
    )

    def apply_system_config(self, system_config: dict[str, Any] | None) -> None:
        """Apply a ``_system_config`` dict (reference: ray.init(_system_config=...)).

        The applied dict is remembered so cluster subprocesses can inherit it
        (the reference head propagates _system_config cluster-wide the same
        way)."""
        global _applied_system_config
        if not system_config:
            return
        for key, value in system_config.items():
            if not hasattr(self, key):
                raise ValueError(f"Unknown system config key: {key!r}")
            setattr(self, key, value)
        _applied_system_config.update(system_config)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, raw: str) -> "RayTpuConfig":
        cfg = cls()
        for key, value in json.loads(raw).items():
            setattr(cfg, key, value)
        return cfg


_config: RayTpuConfig | None = None
_applied_system_config: dict[str, Any] = {}


def global_config() -> RayTpuConfig:
    global _config
    if _config is None:
        _config = RayTpuConfig()
        # Subprocesses inherit the driver's _system_config via env.
        # Of a reference runtime's dict, the knobs this copy has.
        inherited = os.environ.get("RAYTPU_SYSTEM_CONFIG")
        if inherited:
            _config.apply_system_config(
                {k: v for k, v in json.loads(inherited).items() if hasattr(_config, k)})
    return _config


def applied_system_config() -> dict[str, Any]:
    return dict(_applied_system_config)


def reset_config() -> None:
    global _config
    _config = None
    _applied_system_config.clear()
