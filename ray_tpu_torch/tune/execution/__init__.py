from ray_tpu_torch.tune.execution.tune_controller import TuneController

__all__ = ["TuneController"]
