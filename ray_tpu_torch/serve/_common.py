"""Request deadlines for the port's serving path.

The port's own copy of the parts of ray_tpu's ``Deadline`` /
``current_deadline`` (``serve/_private/common.py``) and
``DeadlineExceededError`` (``exceptions.py``) that the batcher uses: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import contextvars
import math
import time
from dataclasses import dataclass
from typing import Optional


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before it completed."""

    def __init__(self, detail: str = ""):
        self.detail = detail
        super().__init__(detail or "request deadline exceeded")

    def __reduce__(self):
        return (DeadlineExceededError, (self.detail,))


@dataclass(frozen=True)
class Deadline:
    """A point on this process's monotonic clock by which the request must
    finish. ``at_monotonic`` is ``math.inf`` for unbounded requests."""

    at_monotonic: float = math.inf

    @classmethod
    def after(cls, budget_s: Optional[float]) -> "Deadline":
        if budget_s is None:
            return cls(math.inf)
        return cls(time.monotonic() + max(0.0, float(budget_s)))

    def expired(self) -> bool:
        return self.at_monotonic - time.monotonic() <= 0.0


_current_deadline: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "ray_tpu_torch_serve_deadline", default=None
)


def current_deadline() -> Optional[Deadline]:
    return _current_deadline.get()


def set_current_deadline(deadline: Optional[Deadline]):
    """Sets the ambient request deadline; returns a contextvar token the
    caller hands to ``reset_current_deadline``."""
    return _current_deadline.set(deadline)


def reset_current_deadline(token) -> None:
    _current_deadline.reset(token)
