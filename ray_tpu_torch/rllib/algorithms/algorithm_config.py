"""AlgorithmConfig — the fluent, validated config object.

Role-equivalent of rllib/algorithms/algorithm_config.py :: AlgorithmConfig
(SURVEY §2.8): chained .environment().env_runners().training().learners()
 .evaluation() setters, .build_algo() to construct the Algorithm. Copyable
and serializable; algorithm subclasses extend `training()` kwargs.

A copy of ray_tpu's ``rllib/algorithms/algorithm_config.py``, less the
runtime's usage telemetry in ``build_algo``, which takes the device the
learner runs on (cuda unless the caller asks for the CPU).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional, Type


def default_policy_mapping_fn(agent_id, *args, **kwargs) -> str:
    """Single-module default: every agent maps to 'default_policy'."""
    return "default_policy"


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[Type] = None):
        self.algo_class = algo_class
        # environment
        self.env: Any = None
        self.env_config: dict = {}
        # env runners
        self.num_env_runners: int = 2
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 200
        self.explore: bool = True
        # training (common)
        self.gamma: float = 0.99
        self.lr: float = 5e-4
        self.train_batch_size: int = 4000
        self.grad_clip: float = 40.0
        self.model: dict = {"fcnet_hiddens": (256, 256)}
        # learners
        self.num_learners: int = 0
        self.num_tpus_per_learner: int = 0
        # evaluation
        self.evaluation_interval: int = 0
        self.evaluation_duration: int = 5
        # connectors (ConnectorV2 pipelines; factories so every runner /
        # learner builds its own stateful instance)
        self.env_to_module_connector: Optional[Callable] = None
        self.module_to_env_connector: Optional[Callable] = None
        self.learner_connector: Optional[Callable] = None
        # multi-agent (reference: config.multi_agent(policies=...,
        # policy_mapping_fn=...)). ``policies`` maps module_id → None
        # (infer spaces from the env) or an RLModuleSpec.
        self.policies: Optional[dict] = None
        self.policy_mapping_fn: Callable = default_policy_mapping_fn
        # reproducibility
        self.seed: Optional[int] = None
        # RLModule override
        self.rl_module_spec = None

    # -- fluent setters --------------------------------------------------
    def environment(self, env: Any = None, *, env_config: dict | None = None):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(
        self,
        *,
        num_env_runners: int | None = None,
        num_envs_per_env_runner: int | None = None,
        rollout_fragment_length: int | None = None,
        explore: bool | None = None,
        env_to_module_connector: Callable | None = None,
        module_to_env_connector: Callable | None = None,
    ):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if explore is not None:
            self.explore = explore
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        return self

    def multi_agent(
        self,
        *,
        policies: dict | None = None,
        policy_mapping_fn: Callable | None = None,
    ):
        if policies is not None:
            # Accept {"p0", "p1"} set/list or {"p0": spec_or_None} dict.
            if isinstance(policies, (set, list, tuple)):
                policies = {p: None for p in policies}
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    @property
    def is_multi_agent(self) -> bool:
        return self.policies is not None

    def training(self, **kwargs):
        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown training option {key!r}")
            setattr(self, key, value)
        return self

    def learners(
        self,
        *,
        num_learners: int | None = None,
        num_tpus_per_learner: int | None = None,
    ):
        if num_learners is not None:
            self.num_learners = num_learners
        if num_tpus_per_learner is not None:
            self.num_tpus_per_learner = num_tpus_per_learner
        return self

    def evaluation(
        self,
        *,
        evaluation_interval: int | None = None,
        evaluation_duration: int | None = None,
    ):
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    def rl_module(self, *, rl_module_spec=None, model_config: dict | None = None):
        if rl_module_spec is not None:
            self.rl_module_spec = rl_module_spec
        if model_config is not None:
            self.model.update(model_config)
        return self

    def debugging(self, *, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    # -- materialization -------------------------------------------------
    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def validate(self) -> None:
        if self.env is None:
            raise ValueError("config.environment(env=...) is required")
        if self.train_batch_size <= 0:
            raise ValueError("train_batch_size must be positive")

    def learner_config_dict(self) -> dict:
        return {
            "lr": self.lr,
            "gamma": self.gamma,
            "grad_clip": self.grad_clip,
        }

    def build_algo(self, device=None):
        """The algorithm, its learner on ``device`` (cuda by default)."""
        if self.algo_class is None:
            raise ValueError("no algorithm class bound to this config")
        self.validate()
        return self.algo_class(self.copy(), device=device)

    # reference alias
    build = build_algo

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.__dict__.items():
            if key in ("algo_class", "rl_module_spec"):
                continue
            out[key] = value
        return out
