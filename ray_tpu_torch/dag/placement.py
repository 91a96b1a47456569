"""Compile-time placement plan for compiled graphs.

The counterpart of ray_tpu's ``dag/placement.py``. Compiling a graph pins
every actor BEFORE any channel opens: the channel family of an edge (shm,
device or socket) is a pure function of this plan, every actor gets a
stable device-plane rank (the driver 0, actors 1..N in graph order), and an
actor that cannot be placed fails the compile instead of silently moving
an edge to a slower family.

The reference asks the controller's actor table. The port's actors are the
local task layer's (``_private.local_tasks``), so the plan reads that
layer's table (``actor_info``): on one host every actor and the driver
share one node, the host's name.
"""

from __future__ import annotations

import socket

from ray_tpu_torch._private import local_tasks


class PlacementError(RuntimeError):
    """An actor's placement could not be resolved at compile time."""


class PlacementPlan:
    """Resolved placement for one compiled graph: the driver's node and,
    per actor, its node and device-plane rank."""

    def __init__(self, driver_node: str, actors: dict[str, dict]):
        self.driver_node = driver_node
        self.actors = actors  # actor_id -> {"node_id": str, "rank": int}

    @classmethod
    def resolve(cls, actor_ids, timeout: float = 60.0) -> "PlacementPlan":
        """Waits for each actor to be scheduled (a compile usually runs
        right after the actors' creation) and raises PlacementError for an
        unknown or dead one: an unplaceable graph fails at compile, not at
        its first execute."""
        node = socket.gethostname()
        actors: dict[str, dict] = {}
        for rank, aid in enumerate(actor_ids, start=1):
            try:
                info = local_tasks.actor_info(aid, wait_ready=True, timeout=timeout)
            except Exception as exc:
                raise PlacementError(
                    f"placement query failed for actor {aid}: "
                    f"{type(exc).__name__}: {exc}") from exc
            state = info.get("state")
            if state != "ALIVE":
                raise PlacementError(
                    f"actor {aid} has no live placement (state={state!r}, "
                    f"cause={info.get('death_cause')!r})")
            actors[aid] = {"node_id": node, "rank": rank, "address": info.get("address")}
        return cls(node, actors)

    # -- queries ---------------------------------------------------------
    def node_of(self, actor_id: str | None) -> str:
        """Hosting node; None means the driver."""
        if actor_id is None:
            return self.driver_node
        return self.actors[actor_id]["node_id"]

    def rank_of(self, actor_id: str | None) -> int:
        """Device-plane rank; the driver is rank 0."""
        if actor_id is None:
            return 0
        return self.actors[actor_id]["rank"]

    def colocated(self, a: str | None, b: str | None) -> bool:
        return self.node_of(a) == self.node_of(b)

    @property
    def world_size(self) -> int:
        return len(self.actors) + 1  # + driver


def edge_family(plan: PlacementPlan, src: str | None, dst: str | None,
                hint: str | None, override: str | None) -> str:
    """Channel family for one edge (src/dst are actor ids; None = the
    driver endpoint). Precedence: same-actor > compile-wide override >
    per-node hint > auto (co-located -> shm, else device)."""
    if src is not None and src == dst:
        return "local"
    choice = override or hint
    if choice is None:
        return "shm" if plan.colocated(src, dst) else "device"
    if choice == "shm" and not plan.colocated(src, dst):
        raise ValueError(
            f"edge {src or 'driver'} -> {dst or 'driver'} requested an shm "
            "channel but the endpoints are on different nodes")
    if choice not in ("shm", "device", "socket"):
        raise ValueError(f"unknown channel family {choice!r}")
    return choice
