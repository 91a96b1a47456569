"""Serving pieces of the port: the dynamic batcher in front of the model."""

from ray_tpu_torch.serve._common import DeadlineExceededError
from ray_tpu_torch.serve.batching import batch

__all__ = ["DeadlineExceededError", "batch"]
