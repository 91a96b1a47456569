"""Training: the single-device step (``step``), sharded training and the
split step across a collective group (``torch_utils``), checkpoints in the
JAX package's format (``checkpoint``), and ``TorchTrainer`` with its
session and configs (``trainer``, ``session``, ``config``), with each
rank's dataset shard (``get_dataset_shard``)."""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.session import (
    TrainContext, get_checkpoint, get_context, get_dataset_shard, report,
)
from ray_tpu_torch.train.trainer import Result, TorchTrainer

__all__ = [
    "Checkpoint", "CheckpointConfig", "FailureConfig", "Result", "RunConfig", "ScalingConfig",
    "TorchTrainer", "TrainContext", "get_checkpoint", "get_context", "get_dataset_shard",
    "report",
]
