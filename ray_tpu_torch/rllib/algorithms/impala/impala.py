"""IMPALA — async sampling + V-trace off-policy correction.

Port of ray_tpu's ``rllib/algorithms/impala/impala.py``: env runners
sample continuously (``EnvRunnerGroup.sample_async`` / ``collect_ready``),
the learner consumes whatever arrived, and V-trace's importance weights
(rho, c) correct for the runners' stale policies.

V-trace is a reverse recursion over the whole fragment
(``acc = delta_t + discount_t * c_t * acc``), a ``lax.scan`` in the
reference. Its outputs are stop-gradient targets, so the port computes
them on the host, where GAE runs for PPO: the loss's forward runs on the
learner's device, then one copy brings the target policy's logp and the
values (with the behaviour logp, rewards, discounts and bootstrap value)
to the host, the recursion runs in f32 numpy in the reference's order,
and one copy takes vs and the policy-gradient advantages back. A Python
loop of T steps on the card would issue about 3·T launches an update.

The reference treats a runner's whole env-major fragment ([T, B]
flattened env by env) as one sequence, zeroing discounts only at
``terminated | truncated``; so at the seam between two envs' streams the
next stream's values flow into the previous stream's last row, and only
the fragment's last row gets a bootstrap value. The port does the same
(ROADMAP Queue C records the divergence from per-sequence V-trace).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTION_LOGP, ACTIONS, NEXT_OBS, OBS, REWARDS, SampleBatch, TERMINATEDS, TRUNCATEDS,
)


def vtrace(
    behaviour_logp,
    target_logp,
    rewards,
    values,
    bootstrap_value,
    discounts,
    clip_rho_threshold: float = 1.0,
    clip_c_threshold: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """V-trace targets (Espeholt et al. 2018) over one [T] sequence, in f32
    numpy: (vs, pg_advantages), the reference's operations in its order."""
    f32 = np.float32
    behaviour_logp, target_logp, rewards, values, discounts = (
        np.asarray(a, f32) for a in (behaviour_logp, target_logp, rewards, values, discounts))
    bootstrap = np.asarray(bootstrap_value, f32).reshape(1)
    rhos = np.exp(target_logp - behaviour_logp)
    clipped_rhos = np.minimum(f32(clip_rho_threshold), rhos)
    clipped_cs = np.minimum(f32(clip_c_threshold), rhos)
    next_values = np.concatenate([values[1:], bootstrap])
    deltas = clipped_rhos * (rewards + discounts * next_values - values)
    decay = discounts * clipped_cs
    vs_minus_v = np.empty_like(deltas)
    acc = f32(0.0)
    for t in range(len(deltas) - 1, -1, -1):
        acc = deltas[t] + decay[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    next_vs = np.concatenate([vs[1:], bootstrap])
    pg_advantages = clipped_rhos * (rewards + discounts * next_vs - values)
    return vs, pg_advantages


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or IMPALA)
        self.lr = 5e-4
        self.train_batch_size = 500
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.clip_rho_threshold: float = 1.0
        self.clip_c_threshold: float = 1.0
        self.max_queue_len: int = 8
        self.rollout_fragment_length = 50


class IMPALALearner(Learner):
    def _vtrace(self, batch: dict, logp: torch.Tensor, vf: torch.Tensor) -> tuple:
        """(vs, pg_advantages) on the device, from V-trace on the host."""
        cfg = self.config
        done = torch.logical_or(batch[TERMINATEDS], batch[TRUNCATEDS])
        discounts = cfg.get("gamma", 0.99) * (1.0 - done.float())
        host = torch.stack([batch[ACTION_LOGP].float(), logp.detach(), batch[REWARDS].float(),
                            vf.detach(), batch["bootstrap_value"].float(), discounts]).cpu().numpy()
        vs, pg_adv = vtrace(host[0], host[1], host[2], host[3], host[4][0], host[5],
                            cfg.get("clip_rho_threshold", 1.0), cfg.get("clip_c_threshold", 1.0))
        targets = torch.from_numpy(np.stack([vs, pg_adv])).to(logp.device)
        return targets[0], targets[1]

    def compute_loss(self, params, batch: dict):
        cfg = self.config
        logp, entropy, vf = self.module.action_logp(params, batch[OBS], batch[ACTIONS])
        # [T] sequences laid out env-major & episode-contiguous by the
        # runner; the whole fragment is one sequence with discounts zeroed
        # at episode ends (the flattened-vtrace trick of the reference).
        vs, pg_adv = self._vtrace(batch, logp, vf)
        policy_loss = -torch.mean(logp * pg_adv)
        vf_loss = 0.5 * torch.mean((vf - vs) ** 2)
        entropy_mean = torch.mean(entropy)
        total = (
            policy_loss
            + cfg.get("vf_loss_coeff", 0.5) * vf_loss
            - cfg.get("entropy_coeff", 0.01) * entropy_mean
        )
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": entropy_mean}


class IMPALA(Algorithm):
    learner_class = IMPALALearner

    def _learner_config(self) -> dict:
        cfg = super()._learner_config()
        cfg.update(
            vf_loss_coeff=self.config.vf_loss_coeff,
            entropy_coeff=self.config.entropy_coeff,
            clip_rho_threshold=self.config.clip_rho_threshold,
            clip_c_threshold=self.config.clip_c_threshold,
        )
        return cfg

    def training_step(self) -> dict:
        config = self.config
        # Async harvest: take whatever fragments finished; runners are
        # immediately re-submitted (continuous sampling).
        ready = self.env_runner_group.collect_ready(timeout=10.0)
        if not ready:
            return {}
        metrics: dict = {}
        trained = 0
        for fragment in ready[: config.max_queue_len]:
            self._total_env_steps += len(fragment)
            fragment["bootstrap_value"] = np.full(
                len(fragment), self._bootstrap_value(fragment), dtype=np.float32
            )
            metrics = self.learner_group.update(fragment)
            trained += len(fragment)
        # Weights go back at iteration cadence (runners run off-policy).
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        metrics["num_env_steps_trained"] = trained
        return metrics

    def _bootstrap_value(self, fragment: SampleBatch) -> float:
        """V(next_obs) of the fragment's last row, 0 where it terminated."""
        if bool(fragment[TERMINATEDS][-1]):
            return 0.0
        return float(self._value_fn()(fragment[NEXT_OBS][-1][None])[0])
