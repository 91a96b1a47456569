"""Replica choice and route matching.

The port's copy of ray_tpu's ``serve/_private/routing.py``: ``HashRing``,
rendezvous (highest-random-weight) hashing of a request's affinity key over
the live replicas with a bounded-load fallback, and the longest-prefix
route match of ``RoutingMixin._match``. The key is, in this order, the
session id, the multiplexed model id, the shape key and the request id:
a session's or a model's requests stay on the replica holding its state,
and keyless requests spread.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Mapping, Optional


class HashRing:
    """Rendezvous-hash replica selector with bounded-load fallback. Pure
    data: callers pass the member list and each member's load on every
    pick."""

    def __init__(self, members: Iterable[str] = ()):
        self._members: tuple[str, ...] = tuple(sorted(members))

    def update(self, members: Iterable[str]) -> None:
        self._members = tuple(sorted(members))

    @property
    def members(self) -> tuple[str, ...]:
        return self._members

    @staticmethod
    def _score(key: str, member: str) -> int:
        # blake2b over "key|member": stable across processes and runs.
        digest = hashlib.blake2b(f"{key}|{member}".encode(), digest_size=8).digest()
        return int.from_bytes(digest, "big")

    def rank(self, key: str) -> list[str]:
        """Members by descending score for ``key``: the key's preference
        order. Removing a member leaves the others' order as it was."""
        return sorted(self._members, key=lambda m: self._score(key, m), reverse=True)

    def pick(
        self,
        key: str,
        load: Optional[Mapping[str, int]] = None,
        max_load: Optional[int] = None,
    ) -> Optional[str]:
        """The key's most-preferred member whose load is under
        ``max_load``; if every member is saturated, the least-loaded one."""
        order = self.rank(key)
        if not order:
            return None
        if load is None or max_load is None:
            return order[0]
        for member in order:
            if load.get(member, 0) < max_load:
                return member
        return min(order, key=lambda m: load.get(m, 0))


def match_route(routes: Mapping[str, str], path: str) -> Optional[tuple[str, str]]:
    """Longest-prefix route match: (route, qualified deployment) or None."""
    best = None
    for route, deployment in routes.items():
        if path == route or path.startswith(route.rstrip("/") + "/") or route == "/":
            if best is None or len(route) > len(best[0]):
                best = (route, deployment)
    return best
