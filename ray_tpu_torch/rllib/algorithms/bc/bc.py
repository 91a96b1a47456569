"""BC — behavior cloning (offline RL).

Port of ray_tpu's ``rllib/algorithms/bc/bc.py``: supervised imitation of a
dataset policy — maximize the log-likelihood of the dataset's actions
under the module's action distribution, on the learner's device; no
environment interaction during training (the env is only probed for
spaces and used by ``evaluate``).

``OfflineAlgorithm`` is the shape BC and CQL share (the reference writes
it out in each): spaces from a probe env, a local learner, no rollout
fleet (``_NullRunnerGroup`` keeps ``train``'s surface), minibatches from
``OfflineData``. gymnasium is imported where a probe env is made.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.offline.offline_data import OfflineData
from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, OBS
from ray_tpu_torch.rllib.utils.metrics import MetricsLogger


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.updates_per_iteration: int = 100
        # dataset / path / SampleBatch — see OfflineData
        self.input_: object = None
        self.num_env_runners = 0

    def offline_data(self, *, input_=None):
        if input_ is not None:
            self.input_ = input_
        return self

    def validate(self) -> None:
        super().validate()
        if self.input_ is None:
            raise ValueError("BC needs config.offline_data(input_=...)")


class BCLearner(Learner):
    def compute_loss(self, params, batch: dict):
        logp, entropy, _vf = self.module.action_logp(params, batch[OBS], batch[ACTIONS])
        loss = -torch.mean(logp)
        return loss, {"bc_logp": torch.mean(logp), "entropy": torch.mean(entropy)}


class _NullRunnerGroup:
    """Offline algorithms have no rollout fleet; keep train()'s surface."""

    def sync_weights(self, params) -> None:
        pass

    def get_metrics(self) -> dict:
        return {"episode_return_mean": np.nan, "episode_len_mean": np.nan,
                "num_episodes": 0}

    def get_connector_state(self) -> dict:
        return {}

    def stop(self) -> None:
        pass


class OfflineAlgorithm(Algorithm):
    """Spaces and a local learner, no env-runner fleet, offline minibatches."""

    required_columns = frozenset({OBS, ACTIONS})

    def __init__(self, config, device=None):
        # No Algorithm.__init__: offline training needs spaces + learner
        # but no env-runner fleet.
        self.config = config
        self.device = resolve_device(device)
        self.iteration = 0
        self._total_env_steps = 0
        self._start = time.time()
        self.metrics = MetricsLogger()
        probe_env = self._make_env()
        self.observation_space = probe_env.observation_space
        self.action_space = probe_env.action_space
        self.module_observation_space = self.observation_space
        probe_env.close()
        spec = config.rl_module_spec or RLModuleSpec(model_config=dict(config.model))
        self.learner_group = LearnerGroup(
            self.learner_class, spec, self.observation_space,
            self.action_space, self._learner_config(), num_learners=0, device=self.device,
        )
        self.env_runner_group = _NullRunnerGroup()
        self.offline_data = OfflineData(config.input_)
        missing = set(self.required_columns) - set(self.offline_data.columns)
        if missing:
            raise ValueError(f"offline dataset lacks columns: {missing}")

    def training_step(self) -> dict:
        learner = self.learner_group.local_learner
        metrics: dict = {}
        for _ in range(self.config.updates_per_iteration):
            batch = self.offline_data.sample(self.config.train_batch_size)
            metrics = learner.update(batch)
        metrics["num_samples_trained"] = (
            self.config.updates_per_iteration * self.config.train_batch_size
        )
        return metrics


class BC(OfflineAlgorithm):
    learner_class = BCLearner
