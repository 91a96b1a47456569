"""EnvRunner — CPU rollout workers.

Port of ray_tpu's ``rllib/env/env_runner.py`` (``SingleAgentEnvRunner``):
gymnasium vector envs stepped in a hot loop, actions from
``RLModule.forward_exploration``, fixed-length rollout fragments returned
as SampleBatch. The runner's module copy is built with ``device="cpu"``
on purpose: rollouts step the env one batch of observations at a time,
and the reference keeps them on the host for that reason ("learners own
the accelerator"); the learner's weights arrive as numpy through
``set_weights``. Forwards run under ``torch.no_grad``. Sampling draws from
a ``torch.Generator`` seeded from ``seed + worker_index`` (the reference
splits a JAX PRNG key each step).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.core.learner import _tensors
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTION_LOGP, ACTIONS, EPS_ID, NEXT_OBS, OBS, REWARDS, SampleBatch,
    TERMINATEDS, TRUNCATEDS, VF_PREDS,
)


class SingleAgentEnvRunner:
    """One per runner process; `sample()` returns a rollout fragment."""

    def __init__(
        self,
        env_creator: Callable[[], Any] | str,
        module_spec,
        *,
        num_envs: int = 1,
        rollout_fragment_length: int = 200,
        worker_index: int = 0,
        explore: bool = True,
        seed: Optional[int] = None,
        env_to_module: Callable[[], Any] | None = None,
        module_to_env: Callable[[], Any] | None = None,
    ):
        import gymnasium as gym

        from ray_tpu_torch.rllib.connectors import (
            default_env_to_module, default_module_to_env,
        )

        if isinstance(env_creator, str):
            self.env = gym.make_vec(env_creator, num_envs=num_envs)
        else:
            self.env = env_creator(num_envs)
        self.num_envs = num_envs
        self.rollout_fragment_length = rollout_fragment_length
        self.explore = explore
        # Connector pipelines (ConnectorV2 role): factories so each runner
        # owns its (possibly stateful) pipeline instance.
        self._env_to_module = env_to_module() if env_to_module else default_env_to_module()
        self._module_to_env = module_to_env() if module_to_env else default_module_to_env()
        seed_val = None if seed is None else seed + worker_index
        raw_obs, _ = self.env.reset(seed=seed_val)
        self._obs = self._env_to_module(raw_obs)
        # The module sees the CONNECTOR's output, not the env's raw space —
        # a shape-changing pipeline (framestack, …) implies a wider input.
        obs_space = self.env.single_observation_space
        if tuple(self._obs.shape[1:]) != tuple(obs_space.shape or ()):
            obs_space = gym.spaces.Box(
                -np.inf, np.inf, shape=self._obs.shape[1:], dtype=np.float32
            )
        self.module = module_spec.build(obs_space, self.env.single_action_space, device="cpu")
        self._params = None
        self._gen = torch.Generator().manual_seed(
            seed + worker_index if seed is not None else worker_index * 1000 + 17
        )
        # Recurrent modules (use_lstm): the runner owns one (h, c) per
        # env, threads it through forward_* and zeroes finished envs'
        # rows at episode boundaries.
        self._stateful = bool(getattr(self.module, "is_stateful", False))
        self._state = self.module.initial_state(num_envs) if self._stateful else None
        # Epsilon-greedy override (DQN-style): when set, actions are greedy
        # w.r.t. the module with prob 1-ε and uniform-random with prob ε —
        # applied BEFORE stepping the env so replay data stays consistent.
        self._epsilon: Optional[float] = None
        self._np_rng = np.random.default_rng(
            (seed if seed is not None else 0) * 7919 + worker_index
        )
        self._eps_ids = np.arange(num_envs, dtype=np.int64) + worker_index * 10_000_000
        self._next_eps = self._eps_ids.max() + 1
        self._episode_returns = np.zeros(num_envs)
        self._episode_lens = np.zeros(num_envs, dtype=np.int64)
        self._completed: list[tuple[float, int]] = []

    # -- weights sync ----------------------------------------------------
    def set_weights(self, params) -> str:
        self._params = _tensors(params, "cpu")
        return "ok"

    def set_epsilon(self, epsilon: Optional[float]) -> str:
        self._epsilon = epsilon
        return "ok"

    def get_weights(self):
        return self._params

    def get_connector_state(self) -> dict:
        """Cross-episode env→module state (running normalizers) so
        evaluation pipelines can start from the training distribution."""
        return self._env_to_module.get_state()

    # -- rollout ---------------------------------------------------------
    def _act(self) -> tuple:
        """(actions, logp, vf) for the current observations, as numpy."""
        obs = torch.from_numpy(np.ascontiguousarray(self._obs))
        zeros = np.zeros(self.num_envs)
        if self._epsilon is not None or not self.explore:
            if self._stateful:
                actions, self._state = self.module.forward_inference(
                    self._params, obs, self._state)
            else:
                actions = self.module.forward_inference(self._params, obs)
            actions = actions.numpy()
            if self._epsilon is not None:
                mask = self._np_rng.random(self.num_envs) < self._epsilon
                if mask.any():
                    actions = np.where(
                        mask,
                        self._np_rng.integers(0, self.env.single_action_space.n, self.num_envs),
                        actions,
                    )
            return actions, zeros, zeros
        if self._stateful:
            actions, logp, extra, self._state = self.module.forward_exploration(
                self._params, obs, self._gen, self._state)
        else:
            actions, logp, extra = self.module.forward_exploration(self._params, obs, self._gen)
        return actions.numpy(), logp.numpy(), extra["vf_preds"].numpy()

    @torch.no_grad()
    def sample(self, num_steps: int | None = None) -> SampleBatch:
        if self._params is None:
            raise RuntimeError("set_weights before sample")
        steps = num_steps or self.rollout_fragment_length
        if self._stateful:
            # Truncated BPTT aligned with fragments: zero the recurrent
            # state at every fragment start so the TRAINING recurrence
            # (which zero-inits its windows) replays the exact state
            # trajectory the rollout used — otherwise importance ratios are
            # computed against logps from different hidden states and PPO's
            # clipped updates drift. Set model_config max_seq_len ==
            # rollout_fragment_length for exact window alignment.
            self._state = self.module.initial_state(self.num_envs)
        cols: dict[str, list] = {
            OBS: [], ACTIONS: [], REWARDS: [], TERMINATEDS: [],
            TRUNCATEDS: [], NEXT_OBS: [], ACTION_LOGP: [], VF_PREDS: [],
            EPS_ID: [],
        }
        for _ in range(steps):
            actions_np, logp, vf = self._act()
            env_actions = self._module_to_env(
                actions_np, action_space=self.env.single_action_space
            )
            raw_next, rewards, terms, truncs, _ = self.env.step(env_actions)
            # Transform once per step: NEXT_OBS of step t is OBS of t+1,
            # so stateful connectors (framestack, normalizers) see each
            # observation exactly once. ``dones`` lets per-stream state
            # (framestacks) reset at episode boundaries.
            next_obs = self._env_to_module(raw_next, dones=np.logical_or(terms, truncs))
            cols[OBS].append(self._obs)
            cols[ACTIONS].append(actions_np)
            cols[REWARDS].append(np.asarray(rewards, dtype=np.float32))
            cols[TERMINATEDS].append(terms)
            cols[TRUNCATEDS].append(truncs)
            cols[NEXT_OBS].append(next_obs)
            cols[ACTION_LOGP].append(np.asarray(logp))
            cols[VF_PREDS].append(np.asarray(vf))
            cols[EPS_ID].append(self._eps_ids.copy())

            self._episode_returns += rewards
            self._episode_lens += 1
            done = np.logical_or(terms, truncs)
            if self._stateful and done.any():
                # reset finished envs' recurrent state rows
                keep = torch.from_numpy(1.0 - done.astype(np.float32))[:, None]
                self._state = tuple(s * keep for s in self._state)
            for i in np.nonzero(done)[0]:
                self._completed.append(
                    (float(self._episode_returns[i]), int(self._episode_lens[i]))
                )
                self._episode_returns[i] = 0.0
                self._episode_lens[i] = 0
                self._eps_ids[i] = self._next_eps
                self._next_eps += 1
            self._obs = next_obs

        # [T, B, ...] → flatten env-major so each env's steps stay contiguous
        # (episode boundaries remain detectable via EPS_ID).
        def flat(stacked: list) -> np.ndarray:
            arr = np.stack(stacked)  # [T, B, ...]
            return np.swapaxes(arr, 0, 1).reshape(
                (arr.shape[0] * arr.shape[1],) + arr.shape[2:]
            )

        return SampleBatch({k: flat(v) for k, v in cols.items()})

    def sample_episodes(self, num_episodes: int) -> SampleBatch:
        batches = []
        completed_before = len(self._completed)
        while len(self._completed) - completed_before < num_episodes:
            batches.append(self.sample(self.rollout_fragment_length))
        return SampleBatch.concat_samples(batches)

    # -- metrics ---------------------------------------------------------
    def get_metrics(self) -> dict:
        episodes = self._completed[-100:]
        return {
            "num_episodes": len(self._completed),
            "episode_return_mean": (
                float(np.mean([r for r, _ in episodes])) if episodes else np.nan
            ),
            "episode_len_mean": (
                float(np.mean([l for _, l in episodes])) if episodes else np.nan
            ),
        }

    def ping(self) -> str:
        return "ok"

    def stop(self) -> str:
        self.env.close()
        return "ok"
