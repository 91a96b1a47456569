"""Placement groups — gang scheduling of resource bundles.

The port's copy of ray_tpu's ``util/placement_group.py``, whole.

Role-equivalent of python/ray/util/placement_group.py
(:: placement_group, PlacementGroup, remove_placement_group,
placement_group_table). Strategies: STRICT_PACK / PACK / SPREAD /
STRICT_SPREAD, scheduled by the controller's 2-phase bundle commit
(gcs_placement_group_manager.cc [N3]).

TPU addition: ``tpu_slice_bundles("v4-32")`` builds the bundle list for a
whole pod slice (one bundle per host, STRICT_SPREAD across hosts within the
slice's ICI domain) — the pod-slice placement group of the north star.
"""

from __future__ import annotations

import time
from typing import Any

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker
from ray_tpu_torch._private.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: list[dict], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    def ready(self, timeout: float | None = None):
        """Block until all bundles are committed (reference: pg.ready())."""
        ctx = worker.get_global_context()
        import asyncio

        async def _wait():
            return await ctx.controller.call("pg_ready", {"pg_id": self.id})

        try:
            resp = ctx.io.run(
                asyncio.wait_for(_wait(), timeout) if timeout else _wait(),
                timeout=timeout + 5 if timeout else None,
            )
        except Exception as exc:
            raise exceptions.PlacementGroupUnschedulableError(
                f"placement group {self.id} not ready: {exc}"
            ) from None
        if resp.get("status") != "ok":
            raise exceptions.PlacementGroupUnschedulableError(self.id)
        return self

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(
    bundles: list[dict],
    strategy: str = "PACK",
    name: str = "",
    lifetime: str | None = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty resource dicts")
    ctx = worker.get_global_context()
    pg_id = PlacementGroupID.random()
    ctx.io.run(
        ctx.controller.call(
            "create_placement_group",
            {
                "pg_id": pg_id,
                "bundles": [{k: float(v) for k, v in b.items()} for b in bundles],
                "strategy": strategy,
                "name": name,
                "lifetime": lifetime,
                "job_id": ctx.job_id,
                # Idempotency token (see create_actor): pg_id is
                # client-random, so it names this logical create.
                "mutation_token": f"create-pg:{pg_id}",
            },
        )
    )
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    ctx = worker.get_global_context()
    ctx.io.run(
        ctx.controller.call("remove_placement_group", {"pg_id": pg.id})
    )


def placement_group_table() -> list[dict]:
    ctx = worker.get_global_context()
    return ctx.io.run(ctx.controller.call("list_placement_groups", {}))


# ---------------------------------------------------------------------------
# TPU pod-slice vocabulary
# ---------------------------------------------------------------------------
_SLICE_HOSTS = {
    # generation -> chips per host
    "v4": 4, "v5p": 4, "v5e": 8, "v6e": 8,
}


def tpu_slice_bundles(slice_spec: str) -> list[dict]:
    """Bundles for a whole pod slice, one per TPU host.

    e.g. "v4-32" = 16 chips (v4 sizes count TensorCores) over 4 hosts of 4
    chips -> 4 bundles of {"TPU": 4}. Schedule with STRICT_SPREAD so each
    bundle lands on a distinct host of the slice's ICI domain.
    """
    generation, size = slice_spec.split("-")
    size = int(size)
    chips = size // 2 if generation in ("v4", "v5p") else size
    per_host = _SLICE_HOSTS.get(generation, 4)
    num_hosts = max(1, chips // per_host)
    chips_per_host = chips / num_hosts
    return [
        {"TPU": chips_per_host, f"TPU-{slice_spec}": chips_per_host}
        for _ in range(num_hosts)
    ]


def tpu_slice_placement_group(slice_spec: str, name: str = "") -> PlacementGroup:
    return placement_group(
        tpu_slice_bundles(slice_spec), strategy="STRICT_SPREAD", name=name
    )
