from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

__all__ = ["SampleBatch"]
