"""One host's resource ledger: what this process may place, and what its
local task layer's workers and actors hold.

The counterpart of one node's resource table in ray_tpu's runtime: the
controller's ``cluster_resources()`` and ``available_resources()``
(``ray_tpu/_private/worker.py``), the resource assertions of
``init(num_cpus=, resources=)``, and the placement group a gang waits on
(``ray_tpu/util/gang.py``). The port has no runtime, so one ledger per
process stands in for it:

* Totals. ``CPU`` is the CPUs this process may run on
  (``os.sched_getaffinity``), ``GPU`` the cards ``torch.cuda.device_count()``
  sees, each by its index, and any other key is declared. ``declare(num_cpus=,
  num_gpus=, resources=)`` overrides any of them, as the reference's init
  believes what it is told: a test may declare ``{"TPU": 8}`` or four
  ``trainslot``s on a laptop.
* Cards. A GPU share below one takes the busiest card that still fits it
  (two replicas at 0.5 share one card); a whole number n takes n free
  cards. A lease names the cards each of its bundles took.
* Leases. ``acquire(bundle, n, timeout)`` places all n bundles or none, as
  a placement group does. Requests that wait are served in the order they
  were made. A request the totals can never hold raises at once
  (``InfeasibleResourcesError``, also a ``ValueError``): on one host no
  node can join to make it fit. One that does not fit now waits up to
  ``timeout`` seconds, then raises ``PlacementGroupUnschedulableError``.
  ``release(lease)`` gives everything back.

Scope. The ledger is the process's own, and only the local task layer
(``_private/local_tasks.py``: the data workers and the compiled graphs'
actors of ``data/`` and ``dag/``) takes from it. Gangs, the trainer, Tune's
trials, RLlib's runners and learners, and serve run on the runtime and
lease from its node agent. A child process sees only the cards it was
given, through ``CUDA_VISIBLE_DEVICES``, so its own ledger's GPU total is
its share; CPU counts are not split across processes on one host. The
ledger goes when ROADMAP item 14b-ii-b-2 moves the local task layer onto
the runtime, leaving one table for the host.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

# Shares of a card are compared with this slack (0.1 ten times is 1).
_EPS = 1e-9


class PlacementGroupUnschedulableError(RuntimeError):
    """The request could not be placed within its timeout."""


class InfeasibleResourcesError(PlacementGroupUnschedulableError, ValueError):
    """The request asks for more than this host's totals can ever hold."""


@dataclass
class Lease:
    """What one ``acquire`` placed: its bundles and the cards each took."""

    bundles: list
    cards: list
    ledger: "HostLedger" = field(repr=False)
    released: bool = False

    def visible_devices(self) -> str:
        """The first bundle's cards as ``CUDA_VISIBLE_DEVICES`` names them."""
        return ",".join(str(card) for card in self.cards[0])

    def release(self) -> None:
        self.ledger.release(self)


def _take_cards(cards: list, need: float) -> Optional[list]:
    """Takes ``need`` of the cards' free shares in place; None when it
    does not fit."""
    if need <= 0:
        return []
    if need < 1:
        fits = [i for i, free in enumerate(cards) if free >= need - _EPS]
        if not fits:
            return None
        card = min(fits, key=lambda i: cards[i])
        cards[card] -= need
        return [card]
    whole = [i for i, free in enumerate(cards) if free >= 1.0 - _EPS][: int(need)]
    if len(whole) < int(need):
        return None
    for card in whole:
        cards[card] = 0.0
    return whole


def _plan(bundles: list, free: dict, cards: list) -> Optional[tuple]:
    """(cards of each bundle, free after, cards after) when every bundle
    fits, else None. Pure: ``free`` and ``cards`` are not touched."""
    free, cards, taken = dict(free), list(cards), []
    for bundle in bundles:
        for key, amount in bundle.items():
            if key == "GPU":
                continue
            if free.get(key, 0.0) < amount - _EPS:
                return None
            free[key] = free.get(key, 0.0) - amount
        got = _take_cards(cards, bundle.get("GPU", 0.0))
        if got is None:
            return None
        taken.append(got)
    return taken, free, cards


class HostLedger:
    """This host's totals, what is free, and the leases that hold the rest."""

    def __init__(self, num_cpus: float | None = None, num_gpus: int | None = None,
                 resources: dict | None = None):
        declared = {k: float(v) for k, v in (resources or {}).items()}
        if num_cpus is not None:
            declared["CPU"] = float(num_cpus)
        if num_gpus is not None:
            declared["GPU"] = float(num_gpus)
        if "CPU" not in declared:
            declared["CPU"] = float(len(os.sched_getaffinity(0)))
        if "GPU" not in declared:
            import torch

            declared["GPU"] = float(torch.cuda.device_count())
        if declared["GPU"] != int(declared["GPU"]) or declared["GPU"] < 0:
            raise ValueError(f"GPU counts whole cards, got {declared['GPU']}")
        self._totals = declared
        self._free = {k: v for k, v in declared.items() if k != "GPU"}
        self._cards = [1.0] * int(declared["GPU"])
        self._cond = threading.Condition()
        self._waiting: collections.deque = collections.deque()
        self._tickets = itertools.count()

    # -- reading ---------------------------------------------------------------
    def cluster_resources(self) -> dict:
        return dict(self._totals)

    def available_resources(self) -> dict:
        with self._cond:
            return {**self._free, "GPU": float(sum(self._cards))}

    def can_place(self, bundle: dict, n: int = 1) -> bool:
        """Whether ``n`` copies of ``bundle`` fit in what is free now, by the
        rules ``acquire`` places them with (whole cards, shares of one);
        takes nothing."""
        bundles = [{k: float(v) for k, v in bundle.items()} for _ in range(int(n))]
        with self._cond:
            return _plan(bundles, self._free, self._cards) is not None

    # -- leases ----------------------------------------------------------------
    def acquire(self, bundle: dict, n: int = 1, timeout: float | None = 0.0) -> Lease:
        """Places ``n`` copies of ``bundle`` ({key: amount}) at once. Waits
        up to ``timeout`` seconds (None: no limit) behind the requests made
        before it; raises as the module docstring says."""
        bundle = {k: float(v) for k, v in bundle.items() if float(v) != 0.0}
        gpu = bundle.get("GPU", 0.0)
        if gpu > 1 and gpu != int(gpu):
            raise ValueError(f"GPU is a share of one card or a whole number, got {gpu}")
        bundles = [dict(bundle) for _ in range(int(n))]
        if _plan(bundles, {k: v for k, v in self._totals.items() if k != "GPU"},
                 [1.0] * len(self._cards)) is None:
            raise InfeasibleResourcesError(self._infeasible(bundle, int(n)))
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            ticket = next(self._tickets)
            self._waiting.append(ticket)
            try:
                while True:
                    if self._waiting[0] == ticket:
                        plan = _plan(bundles, self._free, self._cards)
                        if plan is not None:
                            taken, self._free, self._cards = plan
                            return Lease(bundles, taken, self)
                    left = None if deadline is None else deadline - time.monotonic()
                    if left is not None and left <= 0:
                        raise PlacementGroupUnschedulableError(
                            f"{n} x {bundle} could not be placed within {timeout} s: "
                            f"{self.available_resources()} free of {self._totals}")
                    self._cond.wait(left)
            finally:
                self._waiting.remove(ticket)
                self._cond.notify_all()

    def release(self, lease: Lease) -> None:
        """Gives a lease's resources back (a second release does nothing)."""
        with self._cond:
            if lease.released:
                return
            lease.released = True
            for bundle, cards in zip(lease.bundles, lease.cards):
                for key, amount in bundle.items():
                    if key != "GPU":
                        self._free[key] = min(self._totals[key], self._free[key] + amount)
                need = bundle.get("GPU", 0.0)
                for card in cards:
                    self._cards[card] = min(1.0, self._cards[card] + (need if need < 1 else 1.0))
            self._cond.notify_all()

    def _infeasible(self, bundle: dict, n: int) -> str:
        for key, amount in bundle.items():
            have = self._totals.get(key, 0.0)
            if amount * n > have + _EPS:
                return (f"{n} x {bundle} asks for {amount * n:g} {key}s, this host has "
                        f"{have:g}")
        return f"{n} x {bundle} does not fit on this host's {len(self._cards)} cards"


_ledger: HostLedger | None = None
_ledger_lock = threading.Lock()
# A spawned child takes its parent's environment: one start at a time.
_SPAWN_ENV_LOCK = threading.Lock()


@contextlib.contextmanager
def child_visible_devices(visible: str | None):
    """Sets ``CUDA_VISIBLE_DEVICES`` to ``visible`` (a lease's
    ``visible_devices()``) for the child process started inside the block,
    and puts this process's back after it; None leaves it as it is."""
    with _SPAWN_ENV_LOCK:
        before = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible
        try:
            yield
        finally:
            if before is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = before


def ledger() -> HostLedger:
    """This process's ledger, made from the host on first use."""
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = HostLedger()
        return _ledger


def declare(num_cpus: float | None = None, num_gpus: int | None = None,
            resources: dict | None = None) -> HostLedger:
    """Replaces this process's ledger by one with these totals (any left
    out come from the host): the reference's ``init(num_cpus=,
    resources=)``. Leases of the old ledger go back to it. ``declare()``
    returns to the host's own totals."""
    global _ledger
    with _ledger_lock:
        _ledger = HostLedger(num_cpus, num_gpus, resources)
        return _ledger


def cluster_resources() -> dict:
    """This host's totals, by key."""
    return ledger().cluster_resources()


def available_resources() -> dict:
    """What no lease holds, by key (``GPU``: the cards' free shares summed)."""
    return ledger().available_resources()
