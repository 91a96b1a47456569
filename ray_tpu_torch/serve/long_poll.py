"""Membership for routers and proxies: routes, live replicas and policy.

The port's copy of ray_tpu's ``serve/_private/long_poll.py``. One thread a
process (the driver, a proxy, a replica holding a handle) sits in the
serve controller actor's ``poll_update``, an async method parked on the
controller's loop that answers when the membership version passes the one
the thread holds, so a route or replica added after start reaches every
router without polling on the request path. Routers read the cached
snapshot. The thread looks the controller up by name once and again only
after a call to it failed, so a parked poll costs no call to the runtime's
controller.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch.serve._common import CONTROLLER_NAME

_EMPTY = {"actor_names": [], "max_ongoing_requests": 100}

_singleton: Optional["UpdateSubscriber"] = None
_singleton_lock = threading.Lock()


def get_subscriber() -> "UpdateSubscriber":
    """This process's membership source (started at first use)."""
    global _singleton
    with _singleton_lock:
        if _singleton is None:
            _singleton = UpdateSubscriber()
        return _singleton


def reset_subscriber() -> None:
    """Drops the cached subscriber (serve.shutdown)."""
    global _singleton
    with _singleton_lock:
        sub, _singleton = _singleton, None
    if sub is not None:
        sub.stop()


class UpdateSubscriber:
    """A thread parked in the controller's ``poll_update``."""

    POLL_TIMEOUT_S = 10.0

    def __init__(self):
        self._lock = threading.Lock()
        self._snapshot: dict = {}
        self._version = -1
        self._instance: str | None = None
        self._controller = None
        self._have_snapshot = threading.Event()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, name="serve-longpoll", daemon=True)
        self._thread.start()

    # -- readers --------------------------------------------------------
    def wait_ready(self, timeout: float = 30.0) -> bool:
        return self._have_snapshot.wait(timeout)

    def get_routes(self) -> dict:
        self.wait_ready()
        with self._lock:
            return dict(self._snapshot.get("routes", {}))

    def get_replicas(self, qualified_name: str) -> dict:
        self.wait_ready()
        with self._lock:
            return dict(self._snapshot.get("replicas", {}).get(qualified_name, _EMPTY))

    def get_proxies(self) -> list:
        """The ingress proxies: [{"name", "protocol", "host", "port"}], for
        clients that fail over between them."""
        self.wait_ready()
        with self._lock:
            return list(self._snapshot.get("proxies", []))

    def force_refresh(self) -> None:
        """A snapshot fetched now, for a router waiting on a new replica."""
        import ray_tpu_torch

        try:
            self._apply(ray_tpu_torch.get(self._controller_handle().poll_update.remote(-1, 0.0),
                                          timeout=30))
        except Exception:
            # The push path catches up.
            self._controller = None

    def stop(self) -> None:
        self._stopped = True

    # -- internals ------------------------------------------------------
    def _controller_handle(self):
        if self._controller is None:
            from ray_tpu_torch.actor import get_actor

            self._controller = get_actor(CONTROLLER_NAME)
        return self._controller

    def _apply(self, update: dict) -> None:
        with self._lock:
            if update.get("instance") != self._instance:
                # Another controller: its versions start again at 0.
                self._instance = update.get("instance")
                self._version = -1
            if update["version"] >= self._version:
                self._version = update["version"]
                self._snapshot = {"routes": update.get("routes", {}),
                                  "replicas": update.get("replicas", {}),
                                  "proxies": update.get("proxies", [])}
        self._have_snapshot.set()

    def _loop(self) -> None:
        import ray_tpu_torch

        backoff = 0.1
        while not self._stopped:
            try:
                update = ray_tpu_torch.get(
                    self._controller_handle().poll_update.remote(self._version,
                                                                 self.POLL_TIMEOUT_S),
                    timeout=self.POLL_TIMEOUT_S + 30)
                self._apply(update)
                backoff = 0.1
            except Exception:
                # The controller is missing or restarting: keep the last
                # snapshot, look it up again, and back off.
                self._controller = None
                if self._stopped:
                    return
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
