"""AIR-layer integration surface (experiment-tracker sinks).

Role-equivalent of python/ray/air/integrations/ (SURVEY §2.5): tracker
callbacks that forward per-trial configs + metric streams to an
experiment-tracking backend. See ray_tpu_torch.air.integrations.
"""

from ray_tpu_torch.air.integrations import (  # noqa: F401
    FileTrackerCallback, TrackerCallback,
)

__all__ = ["TrackerCallback", "FileTrackerCallback"]
