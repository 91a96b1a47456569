"""Full-jitter exponential backoff, shared by every retry loop of the port.

Copy of ray_tpu's ``util/backoff.py``. Three consumers: serve's handle
retries a request on another replica (``next_delay`` capped by the
request's remaining deadline), ``TorchTrainer.fit`` sleeps between
gang restarts (``sleep``), and the runtime's RPC clients
(``_private/rpc.py``) await a redial on the event loop (``async_sleep``). Both need the same shape, a sleep of U(0,
ceiling) and then a doubled ceiling, because the failure they recover
from is correlated: a gang's death or a replica's crash strands every
caller at once, and a fixed schedule turns the retries into a stampede.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field


@dataclass
class Backoff:
    """Iterative full-jitter backoff state.

    Each ``next_delay()`` samples U(0, ceiling) and doubles the ceiling up
    to ``max_backoff_s``. ``attempts`` counts delays handed out; ``reset()``
    rearms after a success.
    """

    initial_backoff_s: float = 0.1
    max_backoff_s: float = 10.0
    _ceiling: float = field(init=False, default=0.0)
    attempts: int = field(init=False, default=0)

    def __post_init__(self) -> None:
        self._ceiling = self.initial_backoff_s

    def next_delay(self, cap: float | None = None) -> float:
        """Samples the next delay. ``cap`` bounds the sample from above:
        serve's retries pass the request's remaining deadline, so that a
        backoff never sleeps past the budget it is trying to spend."""
        delay = random.uniform(0, self._ceiling)
        self._ceiling = min(self._ceiling * 2, self.max_backoff_s)
        self.attempts += 1
        if cap is not None:
            delay = min(delay, max(0.0, cap))
        return delay

    def sleep(self) -> float:
        """Blocks for the next delay (the trainer's side). Returns it."""
        delay = self.next_delay()
        time.sleep(delay)
        return delay

    async def async_sleep(self) -> float:
        """Event-loop variant (RPC clients). Returns the delay awaited."""
        import asyncio

        delay = self.next_delay()
        await asyncio.sleep(delay)
        return delay

    def reset(self) -> None:
        self._ceiling = self.initial_backoff_s
        self.attempts = 0
