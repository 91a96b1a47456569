"""Public fault-injection API: ``ray_tpu_torch.util.chaos``.

The port's copy of ray_tpu's ``util/chaos.py``. The decision engine lives
in ``ray_tpu_torch._private.chaos``; this module re-exports it and adds
:func:`read_event_log`, which collects every process's JSONL chaos events
in a deterministic order, so that a test can hold two runs of one seed to
the same fault sequence.

Left out until the port runs several nodes on one box (ROADMAP Queue A
item 14c): ``ChaosMonkey``, the driver-side thread that executes a
schedule's ``kills`` against a ``cluster_utils.Cluster``.

Quick start, a fail point armed for its first hit in this process::

    from ray_tpu_torch.util.chaos import FaultSchedule, install

    install(FaultSchedule(seed=7, fail_points={"train.checkpoint.mid_save": 1}),
            log_dir="/tmp/chaos")

Environment form (inherited by every process started afterwards)::

    RAY_TPU_chaos='{"seed": 7, "fail_points": {"serve.proxy.kill": 1}}'
    RAY_TPU_chaos_log_dir=/tmp/chaos
"""

from __future__ import annotations

import json
import os

from ray_tpu_torch._private.chaos import (  # noqa: F401  (public re-exports)
    ChaosFault,
    ChaosInjector,
    FaultSchedule,
    failpoint,
    get_injector,
    install,
    latency_delay,
    reset,
    set_identity,
)

__all__ = [
    "ChaosFault",
    "ChaosInjector",
    "FaultSchedule",
    "failpoint",
    "get_injector",
    "install",
    "latency_delay",
    "read_event_log",
    "reset",
    "set_identity",
]


def read_event_log(log_dir: str) -> list[dict]:
    """Every chaos event from every process, in a deterministic order.

    Events are sorted by (identity, point, method, n), not by wall clock:
    the per-process decision counters are the reproducible coordinates, and
    timestamps differ between runs of one fault sequence. Two runs of the
    same seed and workload give equal lists (the "t" timestamps are
    stripped)."""
    events: list[dict] = []
    if not os.path.isdir(log_dir):
        return events
    for name in sorted(os.listdir(log_dir)):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(log_dir, name)) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except ValueError:
                    continue
                event.pop("t", None)
                events.append(event)
    events.sort(key=lambda e: (e.get("id", ""), e.get("point", ""), e.get("method", ""),
                               e.get("n", 0)))
    return events
