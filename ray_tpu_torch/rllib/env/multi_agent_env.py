"""MultiAgentEnv — the dict-keyed multi-agent environment protocol.

A copy of ray_tpu's ``rllib/env/multi_agent_env.py``: observations,
rewards, terminateds and truncateds are dicts keyed by agent id; the
``terminateds``/``truncateds`` dicts carry the special ``"__all__"`` key
ending the episode for everyone. Agents may have different spaces; the
runner groups them by module via ``policy_mapping_fn``. gymnasium is
imported where ``MultiAgentCartPole`` makes its envs, so the module
imports on a machine without it.
"""

from __future__ import annotations

from typing import Any


class MultiAgentEnv:
    """Subclass surface: ``possible_agents``, per-agent spaces, reset/step."""

    # All agent ids that can ever appear.
    possible_agents: list = []
    # Either dicts keyed by agent id, or single spaces shared by all.
    observation_spaces: Any = None
    action_spaces: Any = None

    def get_observation_space(self, agent_id):
        if isinstance(self.observation_spaces, dict):
            return self.observation_spaces[agent_id]
        return self.observation_spaces

    def get_action_space(self, agent_id):
        if isinstance(self.action_spaces, dict):
            return self.action_spaces[agent_id]
        return self.action_spaces

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        """→ (obs_dict, info_dict)"""
        raise NotImplementedError

    def step(self, action_dict: dict):
        """→ (obs, rewards, terminateds, truncateds, infos) dicts; the
        terminateds/truncateds dicts include "__all__"."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPole-v1 copies, one per agent — the canonical
    multi-agent smoke-test env. Agents terminate independently; the
    episode ends when every agent is done."""

    def __init__(self, config: dict | None = None):
        import gymnasium as gym

        config = config or {}
        self.num_agents = int(config.get("num_agents", 2))
        self.possible_agents = [f"agent_{i}" for i in range(self.num_agents)]
        self._envs = {agent: gym.make("CartPole-v1") for agent in self.possible_agents}
        self.observation_spaces = {a: self._envs[a].observation_space
                                   for a in self.possible_agents}
        self.action_spaces = {a: self._envs[a].action_space for a in self.possible_agents}
        self._done: dict[str, bool] = {}

    def reset(self, *, seed=None, options=None):
        obs, infos = {}, {}
        for i, (agent, env) in enumerate(self._envs.items()):
            agent_seed = None if seed is None else seed + i
            obs[agent], infos[agent] = env.reset(seed=agent_seed)
            self._done[agent] = False
        return obs, infos

    def step(self, action_dict: dict):
        obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for agent, action in action_dict.items():
            if self._done.get(agent, True):
                continue
            o, r, te, tr, info = self._envs[agent].step(action)
            obs[agent] = o
            rewards[agent] = float(r)
            terms[agent] = bool(te)
            truncs[agent] = bool(tr)
            infos[agent] = info
            if te or tr:
                self._done[agent] = True
        terms["__all__"] = all(self._done.values())
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, infos

    def close(self) -> None:
        for env in self._envs.values():
            env.close()
