"""DQN — double Q-learning with (prioritized) replay.

Port of ray_tpu's ``rllib/algorithms/dqn/dqn.py``: epsilon-greedy
rollouts into a replay buffer on the host, double-DQN targets (online net
argmax, target net value), a target sync every
``target_network_update_freq`` env steps, and the TD update on the
learner's device. The target network's tree joins the device batch as the
reference passes it in its batch; the target values are computed under
``torch.no_grad`` (the reference's stop-gradient). Each update hands back
the per-sample |TD| as numpy, in the same copy as the metrics, for the
prioritized buffer's priorities. Dueling and n-step are left out, as in
the reference.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, _clone
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS, NEXT_OBS, OBS, REWARDS, SampleBatch, TERMINATEDS,
)
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self.lr = 5e-4
        self.train_batch_size = 32
        self.replay_buffer_capacity: int = 50_000
        self.prioritized_replay: bool = False
        self.num_steps_sampled_before_learning_starts: int = 1000
        self.target_network_update_freq: int = 500  # env steps
        self.epsilon_initial: float = 1.0
        self.epsilon_final: float = 0.05
        self.epsilon_timesteps: int = 10_000
        self.double_q: bool = True
        self.updates_per_iteration: int = 50
        self.rollout_fragment_length = 4


class DQNLearner(Learner):
    """Q-net learner; the module's pi tower doubles as the Q head."""

    def __init__(self, module, config, seed: int = 0, *, device=None):
        super().__init__(module, config, seed, device=device)
        self.target_params = _clone(self.params)

    def _device_batch(self, batch: SampleBatch) -> dict:
        out = super()._device_batch(batch)
        out.pop("batch_indexes", None)
        out["target_params"] = self.target_params
        return out

    def compute_loss(self, params, batch: dict):
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        q_all = self.module.forward_train(params, batch[OBS])["logits"]
        q = torch.gather(q_all, -1, batch[ACTIONS].long()[:, None])[:, 0]
        with torch.no_grad():
            q_next_target = self.module.forward_train(batch["target_params"],
                                                      batch[NEXT_OBS])["logits"]
            if cfg.get("double_q", True):
                q_next_online = self.module.forward_train(params, batch[NEXT_OBS])["logits"]
                next_actions = torch.argmax(q_next_online, dim=-1)
            else:
                next_actions = torch.argmax(q_next_target, dim=-1)
            q_next = torch.gather(q_next_target, -1, next_actions[:, None])[:, 0]
            not_done = 1.0 - batch[TERMINATEDS].float()
            target = batch[REWARDS] + gamma * not_done * q_next
        td_error = q - target
        weights = batch.get("weights", torch.ones_like(q))
        loss = torch.mean(weights * td_error**2)
        return loss, {
            "td_error_mean": torch.mean(torch.abs(td_error)),
            # per-sample |TD| — prioritized replay needs individual
            # priorities, not the batch mean (a constant priority
            # degenerates PER to biased uniform sampling).
            "td_abs": torch.abs(td_error),
        }

    def update(self, batch: SampleBatch) -> dict:
        loss, metrics = self.compute_loss(self.params, self._device_batch(batch))
        loss.backward()
        self._apply()
        td_abs = metrics.pop("td_abs").detach()
        metrics["total_loss"] = loss
        scalars = torch.stack([v.detach().float() for v in metrics.values()])
        host = torch.cat([scalars, td_abs.float()]).cpu().numpy()
        out = dict(zip(metrics, host[: len(metrics)].tolist()))
        out["td_abs"] = host[len(metrics):]
        return out

    def sync_target(self) -> None:
        self.target_params = _clone(self.params)


class DQN(Algorithm):
    learner_class = DQNLearner

    def __init__(self, config, device=None):
        super().__init__(config, device=device)
        buffer_cls = PrioritizedReplayBuffer if config.prioritized_replay else ReplayBuffer
        self.replay = buffer_cls(config.replay_buffer_capacity, seed=config.seed)
        self._steps_since_target_sync = 0

    def _learner_config(self) -> dict:
        cfg = super()._learner_config()
        cfg.update(double_q=self.config.double_q)
        return cfg

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._total_env_steps / max(1, cfg.epsilon_timesteps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def training_step(self) -> dict:
        config = self.config
        # 1. collect with epsilon-greedy IN the runners (greedy action with
        #    prob 1-ε, uniform random with prob ε, applied before env.step
        #    so replay transitions are consistent).
        eps = self._epsilon()
        self.env_runner_group.set_epsilon(eps)
        fragment = self.env_runner_group.sample()
        self._total_env_steps += len(fragment)
        self._steps_since_target_sync += len(fragment)
        self.replay.add(fragment)

        metrics: dict = {"epsilon": eps, "buffer_size": len(self.replay)}
        if len(self.replay) < config.num_steps_sampled_before_learning_starts:
            return metrics
        # 2. replayed TD updates
        learner = self._local_dqn_learner()
        for _ in range(config.updates_per_iteration):
            batch = self.replay.sample(config.train_batch_size)
            update_metrics = learner.update(batch)
            td_abs = update_metrics.pop("td_abs", None)
            if config.prioritized_replay and "batch_indexes" in batch and td_abs is not None:
                self.replay.update_priorities(batch["batch_indexes"], td_abs)
        metrics.update(update_metrics)
        # 3. target sync + weight broadcast
        if self._steps_since_target_sync >= config.target_network_update_freq:
            learner.sync_target()
            self._steps_since_target_sync = 0
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return metrics

    def _local_dqn_learner(self) -> DQNLearner:
        if self.learner_group.local_learner is None:
            raise ValueError("DQN uses a local learner (num_learners=0)")
        return self.learner_group.local_learner
