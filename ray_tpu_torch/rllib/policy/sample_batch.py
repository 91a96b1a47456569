"""SampleBatch — the lingua-franca array dict.

A copy of ray_tpu's ``rllib/policy/sample_batch.py`` (the port imports
nothing of ray_tpu): a dict of aligned numpy arrays with standard keys,
slicing, concatenation, and minibatch shuffling. ``minibatches`` and
``seq_minibatches`` shuffle with numpy, so both packages draw the same
minibatch order from the same ``np.random.Generator``. Flows env runner →
learner through the gang's pipes (pickled numpy).
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np

OBS = "obs"
NEXT_OBS = "new_obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
ACTION_LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
EPS_ID = "eps_id"
AGENT_ID = "agent_id"


class SampleBatch(dict):
    def __init__(self, data: Mapping[str, np.ndarray] | None = None, **kwargs):
        super().__init__()
        for key, value in {**(data or {}), **kwargs}.items():
            self[key] = np.asarray(value)

    def __len__(self) -> int:
        for value in self.values():
            return len(value)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, rng: np.random.Generator | None = None) -> "SampleBatch":
        rng = rng or np.random.default_rng()
        perm = rng.permutation(len(self))
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(
        self, minibatch_size: int, rng: np.random.Generator | None = None
    ) -> Iterator["SampleBatch"]:
        shuffled = self.shuffle(rng)
        for start in range(0, len(self), minibatch_size):
            mb = shuffled.slice(start, start + minibatch_size)
            if len(mb) == minibatch_size:
                yield mb

    def seq_minibatches(
        self,
        seq_len: int,
        minibatch_size: int,
        rng: np.random.Generator | None = None,
    ) -> Iterator["SampleBatch"]:
        """Sequence-preserving minibatches for recurrent modules: rows
        chop into contiguous seq_len windows, WINDOWS shuffle (never rows
        — that would scramble the recurrence), and each minibatch is a
        whole number of windows."""
        rng = rng or np.random.default_rng()
        n_windows = len(self) // seq_len
        if n_windows == 0:
            yield self
            return
        # never yield ZERO minibatches (a batch smaller than the requested
        # minibatch must still train once)
        per_mb = min(max(1, minibatch_size // seq_len), n_windows)
        order = rng.permutation(n_windows)
        for start in range(0, n_windows - per_mb + 1, per_mb):
            idx = np.concatenate(
                [
                    np.arange(w * seq_len, (w + 1) * seq_len)
                    for w in order[start:start + per_mb]
                ]
            )
            yield SampleBatch({k: v[idx] for k, v in self.items()})

    @staticmethod
    def concat_samples(batches: list["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return SampleBatch()
        keys = set(batches[0])
        return SampleBatch(
            {k: np.concatenate([b[k] for b in batches]) for k in keys}
        )

    def split_by_episode(self) -> list["SampleBatch"]:
        if EPS_ID not in self:
            return [self]
        out = []
        ids = self[EPS_ID]
        boundaries = np.nonzero(np.diff(ids))[0] + 1
        start = 0
        for end in list(boundaries) + [len(self)]:
            out.append(self.slice(start, end))
            start = end
        return [b for b in out if len(b)]


class MultiAgentBatch:
    """Per-module SampleBatches + the env-step count they came from.

    Role-equivalent of rllib/policy/sample_batch.py :: MultiAgentBatch:
    ``policy_batches`` maps module_id → SampleBatch of that module's
    agent-steps; ``env_steps`` counts underlying environment steps (one
    env step can contribute a row to several modules).
    """

    def __init__(self, policy_batches: Mapping[str, SampleBatch], env_steps: int):
        self.policy_batches: dict[str, SampleBatch] = dict(policy_batches)
        self._env_steps = int(env_steps)

    def env_steps(self) -> int:
        return self._env_steps

    def agent_steps(self) -> int:
        return sum(len(b) for b in self.policy_batches.values())

    def __len__(self) -> int:
        return self._env_steps

    def __getitem__(self, module_id: str) -> SampleBatch:
        return self.policy_batches[module_id]

    def __contains__(self, module_id: str) -> bool:
        return module_id in self.policy_batches

    def keys(self):
        return self.policy_batches.keys()

    def items(self):
        return self.policy_batches.items()

    @staticmethod
    def concat_samples(batches: list["MultiAgentBatch"]) -> "MultiAgentBatch":
        merged: dict[str, list[SampleBatch]] = {}
        steps = 0
        for batch in batches:
            steps += batch.env_steps()
            for mid, sub in batch.policy_batches.items():
                merged.setdefault(mid, []).append(sub)
        return MultiAgentBatch(
            {m: SampleBatch.concat_samples(bs) for m, bs in merged.items()},
            steps,
        )
