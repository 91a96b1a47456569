from ray_tpu_torch.tune.schedulers.asha import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
    HyperBandScheduler,
)
from ray_tpu_torch.tune.schedulers.median_stopping import MedianStoppingRule
from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining
from ray_tpu_torch.tune.schedulers.trial_scheduler import FIFOScheduler, TrialScheduler

__all__ = [
    "TrialScheduler",
    "FIFOScheduler",
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
]
