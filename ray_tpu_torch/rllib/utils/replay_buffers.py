"""Replay buffers for off-policy algorithms.

A copy of ray_tpu's ``rllib/utils/replay_buffers.py``: ``ReplayBuffer``
(uniform ring) and ``PrioritizedReplayBuffer`` (proportional
prioritization with importance-sampling weights, Schaul et al. 2016; numpy
cumsum sampling in place of a sum tree). Pure numpy on the host, so a seed
draws the reference's indexes and weights bit for bit.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class ReplayBuffer:
    def __init__(self, capacity: int = 100_000, seed: int | None = None):
        self.capacity = capacity
        self._storage: dict[str, np.ndarray] = {}
        self._size = 0
        self._next_idx = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = len(batch)
        if not self._storage:
            for key, value in batch.items():
                self._storage[key] = np.zeros(
                    (self.capacity,) + value.shape[1:], dtype=value.dtype
                )
        for i in range(n):
            idx = self._next_idx
            for key, value in batch.items():
                self._storage[key][idx] = value[i]
            self._on_add(idx)
            self._next_idx = (self._next_idx + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def _on_add(self, idx: int) -> None:
        pass

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, size=num_items)
        return self._take(idx)

    def _take(self, idx: np.ndarray) -> SampleBatch:
        out = SampleBatch({k: v[idx] for k, v in self._storage.items()})
        out["batch_indexes"] = idx
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(
        self,
        capacity: int = 100_000,
        alpha: float = 0.6,
        beta: float = 0.4,
        seed: int | None = None,
    ):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._priorities = np.zeros(capacity, dtype=np.float64)
        self._max_priority = 1.0

    def _on_add(self, idx: int) -> None:
        self._priorities[idx] = self._max_priority ** self.alpha

    def sample(self, num_items: int) -> SampleBatch:
        prios = self._priorities[: self._size]
        probs = prios / prios.sum()
        idx = self._rng.choice(self._size, size=num_items, p=probs)
        batch = self._take(idx)
        weights = (self._size * probs[idx]) ** (-self.beta)
        batch["weights"] = (weights / weights.max()).astype(np.float32)
        return batch

    def update_priorities(self, idx: np.ndarray, td_errors: np.ndarray) -> None:
        # _max_priority stays in RAW priority units; **alpha is applied
        # exactly once when writing _priorities (also in _on_add, which
        # exponentiates _max_priority itself).
        raw = np.abs(td_errors) + 1e-6
        self._priorities[np.asarray(idx)] = raw ** self.alpha
        self._max_priority = max(self._max_priority, float(raw.max()))
