"""Membership for routers and the proxy: routes, live replicas and policy.

The port's counterpart of ray_tpu's ``serve/_private/long_poll.py``. In the
driver, where the controller lives, a router reads the controller's
snapshot directly. In a replica process, where a handle was passed to
another deployment, a subscriber thread sits in the controller's
``poll_update`` over the serve wire (``_channel``), which answers when the
membership version advances past the one it holds, so a route or replica
added after start reaches the replica's routers without polling on the
request path. The subscriber's calls block its own thread, never the
I/O loop the routers run on.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch.serve import _channel

_EMPTY = {"actor_names": [], "addresses": {}, "max_ongoing_requests": 100}

_source = None
_source_lock = threading.Lock()
_controller_address: Optional[tuple] = None


def set_controller(controller) -> None:
    """The driver: routers read ``controller``'s snapshot (None clears)."""
    global _source
    with _source_lock:
        old, _source = _source, (_LocalMembership(controller) if controller else None)
    if isinstance(old, UpdateSubscriber):
        old.stop()


def set_controller_address(address: tuple) -> None:
    """A replica process: routers subscribe to the controller at
    ``address`` when a handle is first used."""
    global _controller_address
    _controller_address = tuple(address)


def get_subscriber():
    """This process's membership source."""
    global _source
    with _source_lock:
        if _source is None:
            if _controller_address is None:
                raise RuntimeError("serve is not running: call serve.start() or serve.run()")
            _source = UpdateSubscriber(_controller_address)
        return _source


class _Snapshot:
    """Readers over one membership snapshot dict."""

    def _snapshot(self) -> dict:
        raise NotImplementedError

    def get_routes(self) -> dict:
        return dict(self._snapshot().get("routes", {}))

    def get_replicas(self, qualified_name: str) -> dict:
        return dict(self._snapshot().get("replicas", {}).get(qualified_name, _EMPTY))

    def force_refresh(self) -> None:
        pass


class _LocalMembership(_Snapshot):
    def __init__(self, controller):
        self._controller = controller

    def _snapshot(self) -> dict:
        return self._controller.membership()


class UpdateSubscriber(_Snapshot):
    """A thread parked in the controller's ``poll_update``."""

    POLL_TIMEOUT_S = 10.0

    def __init__(self, address: tuple):
        self._peer = _channel.BlockingPeer(address)
        self._force = _channel.BlockingPeer(address)
        self._force_lock = threading.Lock()
        self._lock = threading.Lock()
        self._snapshot_dict: dict = {}
        self._version = -1
        self._instance: str | None = None
        self._have_snapshot = threading.Event()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, name="serve-longpoll", daemon=True)
        self._thread.start()

    def wait_ready(self, timeout: float = 30.0) -> bool:
        return self._have_snapshot.wait(timeout)

    def _snapshot(self) -> dict:
        self.wait_ready()
        with self._lock:
            return self._snapshot_dict

    def force_refresh(self) -> None:
        """A snapshot fetched now, for a router waiting on a new replica."""
        try:
            with self._force_lock:
                self._apply(self._force.call("poll_update", -1, 0.0, timeout=5.0))
        except (ConnectionError, TimeoutError, _channel.RemoteError):
            pass  # the push path catches up

    def stop(self) -> None:
        self._stopped = True

    def _apply(self, update: dict) -> None:
        with self._lock:
            if update.get("instance") != self._instance:
                # Another controller: its versions start again at 0.
                self._instance = update.get("instance")
                self._version = -1
            if update["version"] >= self._version:
                self._version = update["version"]
                self._snapshot_dict = {"routes": update.get("routes", {}),
                                       "replicas": update.get("replicas", {})}
        self._have_snapshot.set()

    def _loop(self) -> None:
        backoff = 0.1
        while not self._stopped:
            try:
                self._apply(self._peer.call("poll_update", self._version, self.POLL_TIMEOUT_S,
                                            timeout=self.POLL_TIMEOUT_S + 30))
                backoff = 0.1
            except (ConnectionError, TimeoutError, _channel.RemoteError):
                # The controller is gone or busy: keep the last snapshot.
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
