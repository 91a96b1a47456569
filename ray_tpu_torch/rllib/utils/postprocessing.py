"""Advantage estimation (GAE) — the env→learner connector math.

A copy of ``compute_gae`` from ray_tpu's ``rllib/utils/postprocessing.py``
(V-trace, IMPALA's, is in ``algorithms/impala/impala.py``, as in the
reference).
Pure numpy over rollout fragments: each episode slice gets its own
backward pass; fragments that end mid-episode bootstrap from
``value_fn(next_obs)``, one call per such slice (PPO's calls run the value
head on the learner's device).
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import (
    ADVANTAGES, EPS_ID, NEXT_OBS, REWARDS, SampleBatch, TERMINATEDS,
    TRUNCATEDS, VALUE_TARGETS, VF_PREDS,
)


def compute_gae(
    batch: SampleBatch,
    *,
    gamma: float = 0.99,
    lambda_: float = 0.95,
    value_fn=None,
    standardize: bool = True,
) -> SampleBatch:
    """Adds ADVANTAGES and VALUE_TARGETS, episode-aware."""
    advantages = np.zeros(len(batch), dtype=np.float32)
    targets = np.zeros(len(batch), dtype=np.float32)
    for episode in _episode_slices(batch):
        start, end = episode
        rewards = batch[REWARDS][start:end]
        values = batch[VF_PREDS][start:end]
        terminated = bool(batch[TERMINATEDS][end - 1])
        truncated = bool(batch[TRUNCATEDS][end - 1])
        if terminated:
            bootstrap = 0.0
        else:
            # Mid-fragment cut or truncation: bootstrap from V(next_obs).
            if value_fn is not None:
                bootstrap = float(
                    np.asarray(
                        value_fn(batch[NEXT_OBS][end - 1][None])
                    ).reshape(-1)[0]
                )
            else:
                bootstrap = float(values[-1])
        next_values = np.append(values[1:], bootstrap)
        deltas = rewards + gamma * next_values - values
        adv = np.zeros_like(deltas)
        acc = 0.0
        for t in range(len(deltas) - 1, -1, -1):
            acc = deltas[t] + gamma * lambda_ * acc
            adv[t] = acc
        advantages[start:end] = adv
        targets[start:end] = adv + values
    if standardize and len(advantages) > 1:
        advantages = (advantages - advantages.mean()) / max(
            advantages.std(), 1e-6
        )
    batch[ADVANTAGES] = advantages
    batch[VALUE_TARGETS] = targets
    return batch


def _episode_slices(batch: SampleBatch) -> list[tuple[int, int]]:
    if EPS_ID not in batch:
        return [(0, len(batch))]
    ids = batch[EPS_ID]
    boundaries = list(np.nonzero(np.diff(ids))[0] + 1)
    edges = [0] + boundaries + [len(batch)]
    return [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)]
