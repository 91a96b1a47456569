from ray_tpu_torch.rllib.offline.offline_data import OfflineData

__all__ = ["OfflineData"]
