"""MultiAgentEnvRunner — a rollout worker for a MultiAgentEnv.

Port of ray_tpu's ``rllib/env/multi_agent_env_runner.py``: steps one
MultiAgentEnv, routes each agent's observation through
``policy_mapping_fn`` to its module, batches per-module forward passes,
and returns a MultiAgentBatch of per-module SampleBatches. An episode's
return is the sum of ALL agents' rewards (the reference's convention).

As the single-agent runner, it runs in a CPU process of the runner gang,
builds its modules with ``device="cpu"``, takes the learners' numpy
weights, and forwards under ``torch.no_grad``; actions are drawn from a
``torch.Generator`` seeded from ``seed + worker_index`` (the reference
splits a JAX PRNG key, seeded with ``seed``, each step). Kept refusals of
the reference: stateful (recurrent) modules and stateful env→module
connectors. Episode ids are ``worker_index * 10_000_000`` plus a counter,
one per agent and episode.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.core.learner import _tensors
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTION_LOGP, ACTIONS, AGENT_ID, EPS_ID, MultiAgentBatch, NEXT_OBS, OBS,
    REWARDS, SampleBatch, TERMINATEDS, TRUNCATEDS, VF_PREDS,
)


class MultiAgentEnvRunner:
    def __init__(
        self,
        env_creator: Callable[[], Any],
        module_spec,  # MultiRLModuleSpec
        *,
        policy_mapping_fn: Callable[[str], str],
        num_envs: int = 1,
        rollout_fragment_length: int = 200,
        worker_index: int = 0,
        explore: bool = True,
        seed: Optional[int] = None,
        env_to_module: Callable[[], Any] | None = None,
        module_to_env: Callable[[], Any] | None = None,
    ):
        from ray_tpu_torch.rllib.connectors import default_env_to_module, default_module_to_env

        self.env = env_creator()
        self.rollout_fragment_length = rollout_fragment_length
        self.explore = explore
        self.policy_mapping_fn = policy_mapping_fn
        self.worker_index = worker_index

        # Module spaces: the spaces of the first agent mapping to each id.
        obs_spaces: dict[str, Any] = {}
        act_spaces: dict[str, Any] = {}
        for agent in self.env.possible_agents:
            mid = policy_mapping_fn(agent)
            obs_spaces.setdefault(mid, self.env.get_observation_space(agent))
            act_spaces.setdefault(mid, self.env.get_action_space(agent))
        self.module = module_spec.build(obs_spaces, act_spaces, device="cpu")
        for mid, module in self.module.items():
            if getattr(module, "is_stateful", False):
                raise ValueError(
                    "MultiAgentEnvRunner does not support stateful "
                    f"(use_lstm) modules yet; module {mid!r} is recurrent"
                )
        self._act_spaces = act_spaces
        self._params: Optional[dict] = None
        # One connector pipeline per module. Stateful pipelines are not
        # supported here: the multi-agent path must also transform
        # NEXT_OBS each step (agents join/leave between steps, so the
        # "obs of t+1" trick the single-agent runner uses doesn't apply),
        # which would double-advance per-stream connector state.
        self._env_to_module = {
            mid: (env_to_module() if env_to_module else default_env_to_module())
            for mid in self.module.keys()
        }
        for mid, pipe in self._env_to_module.items():
            if getattr(pipe, "stateful", False):
                raise ValueError(
                    "MultiAgentEnvRunner does not support stateful "
                    "env_to_module connectors (framestack/normalizers); "
                    f"module {mid!r} got one"
                )
        self._module_to_env = {
            mid: (module_to_env() if module_to_env else default_module_to_env())
            for mid in self.module.keys()
        }
        self._gen = torch.Generator().manual_seed(
            seed + worker_index if seed is not None else worker_index * 1000 + 29
        )
        self._obs, _ = self.env.reset(seed=None if seed is None else seed + worker_index)
        # per-agent episode ids (advance on every env-episode reset)
        base = worker_index * 10_000_000
        self._eps_ids = {agent: base + i for i, agent in enumerate(self.env.possible_agents)}
        self._next_eps = base + len(self.env.possible_agents)
        self._episode_return = 0.0
        self._episode_len = 0
        self._completed: list[tuple[float, int]] = []

    def get_connector_state(self) -> dict:
        # Stateful env→module connectors are rejected in __init__, so
        # there is never running state to sync.
        return {}

    # -- weights ---------------------------------------------------------
    def set_weights(self, params: dict) -> str:
        self._params = _tensors(params, "cpu")
        return "ok"

    def get_weights(self):
        return self._params

    # -- rollout ---------------------------------------------------------
    def _act(self, mid: str, obs_batch: np.ndarray) -> tuple:
        """(actions, logp, vf) of module ``mid`` for a batch, as numpy."""
        obs = torch.from_numpy(np.ascontiguousarray(obs_batch))
        if self.explore:
            actions, logp, extra = self.module[mid].forward_exploration(
                self._params[mid], obs, self._gen)
            return actions.numpy(), logp.numpy(), extra["vf_preds"].numpy()
        actions = self.module[mid].forward_inference(self._params[mid], obs).numpy()
        zeros = np.zeros(len(obs_batch))
        return actions, zeros, zeros

    @torch.no_grad()
    def sample(self, num_steps: int | None = None) -> MultiAgentBatch:
        if self._params is None:
            raise RuntimeError("set_weights before sample")
        steps = num_steps or self.rollout_fragment_length
        cols: dict[str, dict[str, list]] = {
            mid: {
                OBS: [], ACTIONS: [], REWARDS: [], TERMINATEDS: [],
                TRUNCATEDS: [], NEXT_OBS: [], ACTION_LOGP: [], VF_PREDS: [],
                EPS_ID: [], AGENT_ID: [],
            }
            for mid in self.module.keys()
        }
        actual_steps = 0
        for _ in range(steps):
            active = sorted(self._obs.keys())
            if not active:
                self._reset_episode()
                continue
            actual_steps += 1
            # group agents by module
            by_module: dict[str, list[str]] = {}
            for agent in active:
                by_module.setdefault(self.policy_mapping_fn(agent), []).append(agent)
            action_dict: dict[str, Any] = {}
            step_record: dict[str, dict] = {}
            for mid, agents in by_module.items():
                obs_batch = self._env_to_module[mid](
                    np.stack([np.asarray(self._obs[a]) for a in agents])
                )
                actions_np, logp, vf = self._act(mid, obs_batch)
                env_actions = self._module_to_env[mid](
                    actions_np, action_space=self._act_spaces[mid]
                )
                for i, agent in enumerate(agents):
                    action_dict[agent] = env_actions[i]
                    step_record[agent] = {
                        "mid": mid,
                        "obs": obs_batch[i],
                        "action": actions_np[i],
                        "logp": float(logp[i]),
                        "vf": float(vf[i]),
                    }
            next_obs, rewards, terms, truncs, _ = self.env.step(action_dict)
            done_all = terms.get("__all__", False) or truncs.get("__all__", False)
            for agent, rec in step_record.items():
                mid = rec["mid"]
                col = cols[mid]
                col[OBS].append(rec["obs"])
                col[ACTIONS].append(rec["action"])
                col[REWARDS].append(np.float32(rewards.get(agent, 0.0)))
                col[TERMINATEDS].append(bool(terms.get(agent, False)))
                col[TRUNCATEDS].append(bool(truncs.get(agent, False)))
                nxt = next_obs.get(agent)
                if nxt is None:
                    # Agent produced no next obs (already done): repeat its
                    # (transformed) current obs — terminal rows don't
                    # bootstrap, so the value is inert.
                    col[NEXT_OBS].append(rec["obs"])
                else:
                    # Same stateless pipeline as OBS, so both columns live
                    # in the module's input space.
                    col[NEXT_OBS].append(self._env_to_module[mid](np.asarray(nxt)[None])[0])
                col[ACTION_LOGP].append(np.float32(rec["logp"]))
                col[VF_PREDS].append(np.float32(rec["vf"]))
                col[EPS_ID].append(np.int64(self._eps_ids[agent]))
                col[AGENT_ID].append(agent)
                self._episode_return += rewards.get(agent, 0.0)
            self._episode_len += 1
            # keep only live agents' observations for the next step
            self._obs = {
                a: o for a, o in next_obs.items()
                if not (terms.get(a, False) or truncs.get(a, False))
            }
            if done_all:
                self._reset_episode()

        batches = {}
        for mid, col in cols.items():
            if not col[OBS]:
                continue
            agent_ids = col.pop(AGENT_ID)
            data = {k: np.stack(v) for k, v in col.items() if v}
            # When one module serves several agents, rows interleave
            # (agent_0, agent_1, agent_0, ...) with distinct eps_ids.
            # GAE segments on contiguous eps_id runs, so stable-sort by
            # eps_id to make each agent's episode contiguous; the sort is
            # stable, so time order within an episode is preserved.
            order = np.argsort(data[EPS_ID], kind="stable")
            if not np.array_equal(order, np.arange(len(order))):
                data = {k: v[order] for k, v in data.items()}
                agent_ids = [agent_ids[i] for i in order]
            batch = SampleBatch(data)
            batch[AGENT_ID] = np.array(agent_ids)
            batches[mid] = batch
        return MultiAgentBatch(batches, env_steps=actual_steps)

    def _reset_episode(self) -> None:
        self._completed.append((float(self._episode_return), self._episode_len))
        self._episode_return = 0.0
        self._episode_len = 0
        self._obs, _ = self.env.reset()
        for agent in self.env.possible_agents:
            self._eps_ids[agent] = self._next_eps
            self._next_eps += 1

    def sample_episodes(self, num_episodes: int) -> MultiAgentBatch:
        batches = []
        before = len(self._completed)
        while len(self._completed) - before < num_episodes:
            batches.append(self.sample(self.rollout_fragment_length))
        return MultiAgentBatch.concat_samples(batches)

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
