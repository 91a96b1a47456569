"""PPO — clipped-surrogate policy optimization.

Port of ray_tpu's ``rllib/algorithms/ppo/ppo.py``: GAE advantages
(connector math in utils/postprocessing.py), minibatch SGD epochs over
the train batch, clipped surrogate + value loss + entropy bonus, with the
update on the learner's device. The minibatch order comes from
``np.random.default_rng(iteration)``, as in the reference, so both
packages see the same minibatches for the same batch.

GAE bootstraps every episode slice cut mid-fragment from V(next_obs):
``value_function`` runs the value head under ``torch.no_grad`` on the
learner's device, one call per such slice, each one small copy to the
device and one wait for the answer (the reference's call pattern).
Multi-agent PPO waits for ROADMAP Queue A item 7b.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, _tensors
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTION_LOGP, ACTIONS, ADVANTAGES, OBS, SampleBatch, TERMINATEDS,
    TRUNCATEDS, VALUE_TARGETS,
)


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.lr = 3e-4
        self.train_batch_size = 2000
        self.minibatch_size: int = 128
        self.num_epochs: int = 8
        self.clip_param: float = 0.2
        self.vf_clip_param: float = 10.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.0
        self.lambda_: float = 0.95
        self.kl_target: float = 0.02
        self.use_gae: bool = True


class PPOLearner(Learner):
    def compute_loss(self, params, batch: dict):
        cfg = self.config
        if getattr(self.module, "is_stateful", False):
            # recurrent modules replay the rollout's state trajectory —
            # dones reset the training recurrence at episode starts
            dones = torch.logical_or(batch[TERMINATEDS], batch[TRUNCATEDS])
            logp, entropy, vf = self.module.action_logp(
                params, batch[OBS], batch[ACTIONS], dones=dones
            )
        else:
            logp, entropy, vf = self.module.action_logp(params, batch[OBS], batch[ACTIONS])
        ratio = torch.exp(logp - batch[ACTION_LOGP])
        adv = batch[ADVANTAGES]
        clip = cfg.get("clip_param", 0.2)
        surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        policy_loss = -torch.mean(surrogate)
        vf_err = (vf - batch[VALUE_TARGETS]) ** 2
        vf_loss = torch.mean(torch.clamp(vf_err, max=cfg.get("vf_clip_param", 10.0) ** 2))
        entropy_mean = torch.mean(entropy)
        total = (
            policy_loss
            + cfg.get("vf_loss_coeff", 0.5) * vf_loss
            - cfg.get("entropy_coeff", 0.0) * entropy_mean
        )
        kl = torch.mean(batch[ACTION_LOGP] - logp)
        return total, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy_mean,
            "kl": kl,
        }


def value_function(module, params):
    """V(obs) for a numpy batch of observations, on the device of
    ``params``: one copy there, the value head under ``torch.no_grad``,
    one copy back (which waits for the device)."""
    device = params["vf"][0]["w"].device

    def value_fn(obs):
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(obs)).to(device)
            return module.forward_train(params, x)["vf"].cpu().numpy()

    return value_fn


class PPO(Algorithm):
    learner_class = PPOLearner

    def _value_fn(self):
        """V(obs) under the current learner params, on the learner's device."""
        if not hasattr(self, "_vf_module"):
            spec = self.config.rl_module_spec or RLModuleSpec(model_config=dict(self.config.model))
            self._vf_module = spec.build(self.module_observation_space, self.action_space,
                                         device=self.device)
        learner = self.learner_group.local_learner
        params = (learner.params if learner is not None
                  else _tensors(self.learner_group.get_weights(), self.device))
        return value_function(self._vf_module, params)

    def _learner_pipeline(self):
        """Learner connector pipeline: user stages + default GAE."""
        if not hasattr(self, "_learner_conn"):
            from ray_tpu_torch.rllib.connectors import (
                ConnectorPipelineV2, GeneralAdvantageEstimation,
            )

            stages = []
            if self.config.learner_connector is not None:
                user = self.config.learner_connector()
                stages.extend(user.connectors if hasattr(user, "connectors") else [user])
            stages.append(
                GeneralAdvantageEstimation(gamma=self.config.gamma, lambda_=self.config.lambda_)
            )
            self._learner_conn = ConnectorPipelineV2(stages)
        return self._learner_conn

    def _learner_config(self) -> dict:
        cfg = super()._learner_config()
        cfg.update(
            clip_param=self.config.clip_param,
            vf_clip_param=self.config.vf_clip_param,
            vf_loss_coeff=self.config.vf_loss_coeff,
            entropy_coeff=self.config.entropy_coeff,
        )
        return cfg

    def training_step(self) -> dict:
        if self.config.is_multi_agent:
            return self._training_step_multi_agent()
        config = self.config
        # 1. sample until train_batch_size env steps collected
        batches = []
        steps = 0
        while steps < config.train_batch_size:
            fragment = self.env_runner_group.sample()
            steps += len(fragment)
            batches.append(fragment)
        batch = SampleBatch.concat_samples(batches)
        self._total_env_steps += len(batch)
        # 2. learner connectors: GAE (bootstrap values from current params)
        batch = self._learner_pipeline()(batch, value_fn=self._value_fn())
        # 3. minibatch SGD epochs (recurrent modules get sequence-
        # preserving minibatches: shuffling rows would scramble the
        # recurrence windows)
        rng = np.random.default_rng(self.iteration)
        spec = config.rl_module_spec or RLModuleSpec(model_config=dict(config.model))
        stateful = bool(getattr(spec.module_class, "is_stateful", False))
        metrics: dict = {}
        for _ in range(config.num_epochs):
            if stateful:
                seq_len = int(spec.model_config.get("max_seq_len", 16))
                if config.rollout_fragment_length % seq_len != 0:
                    raise ValueError(
                        "recurrent PPO needs rollout_fragment_length "
                        f"({config.rollout_fragment_length}) divisible by "
                        f"max_seq_len ({seq_len}) — otherwise training "
                        "windows straddle unrelated envs' rows"
                    )
                mbs = batch.seq_minibatches(seq_len, config.minibatch_size, rng)
            else:
                mbs = batch.minibatches(config.minibatch_size, rng)
            for mb in mbs:
                metrics = self.learner_group.update(mb)
        # 4. broadcast fresh weights to runners
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        metrics["num_env_steps_trained"] = len(batch)
        return metrics

    def _training_step_multi_agent(self) -> dict:
        raise NotImplementedError("multi-agent PPO waits for ROADMAP Queue A item 7b")
