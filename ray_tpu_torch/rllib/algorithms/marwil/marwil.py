"""MARWIL — monotonic advantage re-weighted imitation learning (offline).

Port of ray_tpu's ``rllib/algorithms/marwil/marwil.py``: behavior cloning
whose log-likelihood term is weighted by ``exp(beta * advantage)``, with a
value head trained on the dataset's discounted returns-to-go. ``beta = 0``
degenerates to plain BC. The update runs on the learner's device.

The offline dataset needs per-timestep ``rewards`` and episode boundaries
(``eps_id`` or ``terminateds``) besides obs/actions; returns-to-go are
computed on the host once at load (``compute_returns_to_go``, copied).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.bc.bc import BC, BCConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS, EPS_ID, OBS, REWARDS, SampleBatch, TERMINATEDS,
)

RETURNS = "returns_to_go"


def compute_returns_to_go(batch: SampleBatch, gamma: float) -> np.ndarray:
    """Discounted return-to-go per row, episode-aware (rows time-ordered
    within each episode, as recorded data naturally is)."""
    rewards = np.asarray(batch[REWARDS], dtype=np.float32)
    n = len(rewards)
    if EPS_ID in batch:
        ids = np.asarray(batch[EPS_ID])
        new_episode = np.zeros(n, dtype=bool)
        new_episode[0] = True
        new_episode[1:] = ids[1:] != ids[:-1]
    elif TERMINATEDS in batch:
        terms = np.asarray(batch[TERMINATEDS], dtype=bool)
        new_episode = np.zeros(n, dtype=bool)
        new_episode[0] = True
        new_episode[1:] = terms[:-1]
    else:
        new_episode = np.zeros(n, dtype=bool)
        new_episode[0] = True
    returns = np.zeros(n, dtype=np.float32)
    acc = 0.0
    for t in range(n - 1, -1, -1):
        acc = rewards[t] + gamma * acc
        returns[t] = acc
        if new_episode[t]:
            acc = 0.0  # row t starts an episode: nothing flows to t-1
    return returns


class MARWILConfig(BCConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self.beta: float = 1.0
        self.vf_coeff: float = 1.0
        # Clip the advantage exponential (reference keeps a running
        # normalizer; a hard cap is the simple stable variant).
        self.advantage_clip: float = 10.0


class MARWILLearner(Learner):
    def compute_loss(self, params, batch: dict):
        cfg = self.config
        logp, entropy, vf = self.module.action_logp(params, batch[OBS], batch[ACTIONS])
        returns = batch[RETURNS]
        advantages = returns - vf
        vf_loss = torch.mean(advantages**2)
        clip = cfg.get("advantage_clip", 10.0)
        # jnp.std: the population standard deviation.
        scale = torch.clamp(torch.std(returns, correction=0), min=1e-3)
        weights = torch.exp(torch.clamp(
            cfg.get("beta", 1.0) * advantages.detach() / scale, -clip, clip))
        bc_loss = -torch.mean(weights * logp)
        total = bc_loss + cfg.get("vf_coeff", 1.0) * vf_loss
        return total, {
            "bc_loss": bc_loss,
            "vf_loss": vf_loss,
            "mean_weight": torch.mean(weights),
            "entropy": torch.mean(entropy),
        }


class MARWIL(BC):
    learner_class = MARWILLearner

    def __init__(self, config: MARWILConfig, device=None):
        super().__init__(config, device=device)
        missing = {REWARDS} - set(self.offline_data.columns)
        if missing:
            raise ValueError(
                f"MARWIL needs column(s) {missing} in the offline dataset "
                "(plus eps_id or terminateds for episode boundaries)"
            )
        self.offline_data._batch[RETURNS] = compute_returns_to_go(
            self.offline_data._batch, config.gamma
        )

    def _learner_config(self) -> dict:
        cfg = super()._learner_config()
        cfg.update(
            beta=self.config.beta,
            vf_coeff=self.config.vf_coeff,
            advantage_clip=self.config.advantage_clip,
        )
        return cfg
