"""Runtime flags the port's tracing and chaos modules read.

The port's copy of the part of ray_tpu's ``_private/config.py`` that
``util/tracing.py`` and ``_private/chaos.py`` need: each knob is
overridable per process through the environment as ``RAY_TPU_<name>``
(read when this module is imported), and a process takes those of the
``_system_config`` its parent's runtime passes it through
``RAYTPU_SYSTEM_CONFIG`` (a JSON object). The rest of the reference's
knobs belong to its runtime core (ROADMAP Queue A item 14b).
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
    """The runtime knobs of tracing and chaos."""

    # DEPRECATED alias, read by ``_private/chaos.py`` as a delay-only
    # FaultSchedule. Prefer RAY_TPU_chaos (a JSON FaultSchedule).
    testing_rpc_delay_ms: int = _env("testing_rpc_delay_ms", 0)
    # Spans (``util/tracing.py``) are recorded only when this is on.
    tracing_enabled: bool = _env("tracing_enabled", False)


_config: RayTpuConfig | None = None


def global_config() -> RayTpuConfig:
    global _config
    if _config is None:
        _config = RayTpuConfig()
        # A process inherits its parent's _system_config through the env;
        # of a reference runtime's whole dict, the knobs kept here.
        inherited = os.environ.get("RAYTPU_SYSTEM_CONFIG")
        for key, value in json.loads(inherited or "{}").items():
            if hasattr(_config, key):
                setattr(_config, key, value)
    return _config
