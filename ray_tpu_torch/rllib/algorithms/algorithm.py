"""Algorithm — the top-level RL training loop.

Port of ray_tpu's ``rllib/algorithms/algorithm.py``, single-agent path:
owns an EnvRunnerGroup (CPU processes) + LearnerGroup (the learner on
``device``, cuda unless the caller asks for the CPU); train() runs one
iteration (sample → learner update → weight sync → metrics); save()/
restore()/from_checkpoint() round-trip learner + config state (the
learner's state as numpy, written atomically); evaluate() runs greedy
episodes, a rollout, on the CPU as the runners do. Keeps the tune
Trainable duck-type (step, save_checkpoint, load_checkpoint). gymnasium
is imported where envs are made.

A multi-agent config (``config.multi_agent(policies=...)``) builds a
``MultiAgentLearnerGroup`` (a learner a module id, each on ``device``) and
runners of ``MultiAgentEnvRunner``; ``config.env`` is then a
``MultiAgentEnv`` class or factory, which the runner processes call with
``env_config`` (it must pickle).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup, MultiAgentLearnerGroup, _tensors
from ray_tpu_torch.rllib.core.multi_rl_module import MultiRLModuleSpec
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.utils.metrics import MetricsLogger


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


def _atomic_write_pickle(path: str, obj) -> None:
    """Pickles ``obj`` to a temporary file beside ``path``, syncs it, and
    renames it over ``path``: a reader sees the old file or the new one."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", prefix=".tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


class _VecEnvCreator:
    """``gym.make_vec(env_id, num_envs, **env_config)``, picklable for the
    runner processes."""

    def __init__(self, env_id: str, env_config: dict):
        self.env_id, self.env_config = env_id, dict(env_config)

    def __call__(self, num_envs: int):
        import gymnasium as gym

        return gym.make_vec(self.env_id, num_envs=num_envs, **self.env_config)


class _MultiAgentEnvCreator:
    """``env_cls(env_config)``, picklable for the runner processes."""

    def __init__(self, env_cls, env_config: dict):
        self.env_cls, self.env_config = env_cls, dict(env_config)

    def __call__(self):
        return self.env_cls(self.env_config)


class Algorithm:
    learner_class = None  # subclasses set

    def __init__(self, config: AlgorithmConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.iteration = 0
        self._total_env_steps = 0
        self._start = time.time()
        self.metrics = MetricsLogger(
            window=getattr(config, "metrics_num_episodes_for_smoothing", 100)
        )
        if config.is_multi_agent:
            self._init_multi_agent(config)
        else:
            self._init_single_agent(config)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def _make_env(self):
        import gymnasium as gym

        config = self.config
        if isinstance(config.env, str):
            return gym.make(config.env, **config.env_config)
        return config.env(config.env_config)

    def _init_single_agent(self, config: AlgorithmConfig) -> None:
        import gymnasium as gym

        spec = config.rl_module_spec or RLModuleSpec(model_config=dict(config.model))
        probe_env = self._make_env()
        self.observation_space = probe_env.observation_space
        self.action_space = probe_env.action_space
        # A shape-changing env→module connector (framestack, …) means the
        # module trains on the pipeline's output space, not the env's.
        self.module_observation_space = self.observation_space
        if config.env_to_module_connector is not None:
            probe_pipe = config.env_to_module_connector()
            probe_out = np.asarray(
                probe_pipe(np.asarray(self.observation_space.sample())[None])
            )
            if tuple(probe_out.shape[1:]) != tuple(self.observation_space.shape or ()):
                self.module_observation_space = gym.spaces.Box(
                    -np.inf, np.inf, shape=probe_out.shape[1:], dtype=np.float32,
                )
        probe_env.close()

        self.learner_group = LearnerGroup(
            self.learner_class,
            spec,
            self.module_observation_space,
            self.action_space,
            self._learner_config(),
            num_learners=config.num_learners,
            device=self.device,
        )
        try:
            self.env_runner_group = EnvRunnerGroup(
                self._env_creator(),
                spec,
                num_env_runners=config.num_env_runners,
                num_envs_per_runner=config.num_envs_per_env_runner,
                rollout_fragment_length=config.rollout_fragment_length,
                seed=config.seed,
                env_to_module=config.env_to_module_connector,
                module_to_env=config.module_to_env_connector,
            )
        except BaseException:
            self.learner_group.stop()
            raise

    def _init_multi_agent(self, config: AlgorithmConfig) -> None:
        from ray_tpu_torch.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner

        if isinstance(config.env, str):
            raise ValueError(
                "multi-agent config.env must be a MultiAgentEnv class or "
                "factory, not a gym id"
            )
        probe = config.env(config.env_config)
        obs_spaces: dict = {}
        act_spaces: dict = {}
        for agent in probe.possible_agents:
            mid = config.policy_mapping_fn(agent)
            if mid not in config.policies:
                raise ValueError(
                    f"policy_mapping_fn({agent!r}) → {mid!r} which is not in "
                    f"config.policies {sorted(config.policies)}"
                )
            obs_spaces.setdefault(mid, probe.get_observation_space(agent))
            act_spaces.setdefault(mid, probe.get_action_space(agent))
        probe.close()
        # module ids with no agent mapped to them would have no spaces
        missing = set(config.policies) - set(obs_spaces)
        if missing:
            raise ValueError(f"no agent maps to policies {sorted(missing)}")
        self.observation_space = obs_spaces
        self.action_space = act_spaces
        self.module_observation_space = obs_spaces

        self._multi_spec = MultiRLModuleSpec({
            mid: spec or RLModuleSpec(model_config=dict(config.model))
            for mid, spec in config.policies.items()
        })
        self.learner_group = MultiAgentLearnerGroup(
            self.learner_class, self._multi_spec, obs_spaces, act_spaces,
            self._learner_config(), device=self.device,
        )
        self.env_runner_group = EnvRunnerGroup(
            _MultiAgentEnvCreator(config.env, config.env_config),
            self._multi_spec,
            num_env_runners=config.num_env_runners,
            num_envs_per_runner=1,
            rollout_fragment_length=config.rollout_fragment_length,
            seed=config.seed,
            env_to_module=config.env_to_module_connector,
            module_to_env=config.module_to_env_connector,
            runner_class=MultiAgentEnvRunner,
            runner_kwargs={"policy_mapping_fn": config.policy_mapping_fn},
        )

    def _env_creator(self):
        config = self.config
        if isinstance(config.env, str):
            return _VecEnvCreator(config.env, config.env_config)
        return config.env

    def _learner_config(self) -> dict:
        return self.config.learner_config_dict()

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

    # -- the iteration ---------------------------------------------------
    def training_step(self) -> dict:
        raise NotImplementedError

    def train(self) -> dict:
        steps_before = self._total_env_steps
        metrics = self.training_step() or {}
        self.iteration += 1
        runner_metrics = self.env_runner_group.get_metrics()
        result = {
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "time_total_s": time.time() - self._start,
            "env_runners": runner_metrics,
            **{f"learner/{k}": v for k, v in metrics.items()},
        }
        result["episode_return_mean"] = runner_metrics.get("episode_return_mean", np.nan)
        # Windowed aggregation (rllib/utils/metrics :: MetricsLogger
        # role): sliding-window return stats, learner-loss windows, and
        # sampling throughput ride every result under "metrics".
        self.metrics.log_throughput(
            "num_env_steps_sampled", self._total_env_steps - steps_before
        )
        ret = result["episode_return_mean"]
        if not np.isnan(ret):
            self.metrics.log_value("episode_return", float(ret))
        self.metrics.log_dict(metrics, prefix="learner_")
        result["metrics"] = self.metrics.reduce()
        if (
            self.config.evaluation_interval
            and self.iteration % self.config.evaluation_interval == 0
        ):
            result["evaluation"] = self.evaluate()
        return result

    # tune.Trainable duck-type
    def step(self) -> dict:
        return self.train()

    @torch.no_grad()
    def evaluate(self) -> dict:
        """Greedy episodes on a fresh env (evaluation duck-type of the
        reference's evaluation workers), stepped on the CPU."""
        if self.config.is_multi_agent:
            return self._evaluate_multi_agent()
        env = self._make_env()
        spec = self.config.rl_module_spec or RLModuleSpec(model_config=dict(self.config.model))
        # Params are shaped for the CONNECTOR's output space; evaluation
        # must run observations through the same pipeline the runners use.
        module = spec.build(self.module_observation_space, self.action_space, device="cpu")
        from ray_tpu_torch.rllib.connectors import default_env_to_module

        params = _tensors(self.learner_group.get_weights(), "cpu")
        # Running statistics (NormalizeObservations) must come from
        # training — a fresh normalizer would map early eval observations
        # to ~0, a distribution the trained policy never saw.
        connector_state = self.env_runner_group.get_connector_state()
        returns = []
        for episode in range(self.config.evaluation_duration):
            # Fresh pipeline per episode: stateful connectors (framestack)
            # must not carry history across episode boundaries —
            # get_state() excludes per-episode history, so restoring it
            # here only seeds the running statistics.
            pipeline = (
                self.config.env_to_module_connector()
                if self.config.env_to_module_connector
                else default_env_to_module()
            )
            if connector_state:
                pipeline.set_state(connector_state)
            # The config's seed seeds the first reset, and the env's own
            # generator the later ones: every evaluation plays the same
            # episodes' starts, so a seeded run evaluates the same each time.
            obs, _ = env.reset(seed=self.config.seed if episode == 0 else None)
            total, done = 0.0, False
            stateful = getattr(module, "is_stateful", False)
            state = module.initial_state(1) if stateful else None
            while not done:
                module_obs = torch.from_numpy(
                    np.ascontiguousarray(pipeline(np.asarray(obs)[None])))
                if stateful:
                    action_arr, state = module.forward_inference(params, module_obs, state)
                else:
                    action_arr = module.forward_inference(params, module_obs)
                action = action_arr.numpy()[0]
                obs, reward, term, trunc, _ = env.step(
                    action.item() if action.shape == () else action
                )
                total += reward
                done = term or trunc
            returns.append(total)
        env.close()
        return {
            "episode_return_mean": float(np.mean(returns)),
            "num_episodes": len(returns),
        }

    def _evaluate_multi_agent(self) -> dict:
        env = self.config.env(self.config.env_config)
        modules = {
            mid: self._multi_spec.module_specs[mid].build(
                self.observation_space[mid], self.action_space[mid], device="cpu")
            for mid in self.config.policies
        }
        params = {mid: _tensors(p, "cpu") for mid, p in self.learner_group.get_weights().items()}
        mapping = self.config.policy_mapping_fn
        returns = []
        for _ in range(self.config.evaluation_duration):
            obs, _ = env.reset()
            total, done = 0.0, False
            while not done and obs:
                actions = {}
                for agent, o in obs.items():
                    mid = mapping(agent)
                    a = modules[mid].forward_inference(
                        params[mid], torch.from_numpy(np.asarray(o, dtype=np.float32).reshape(1, -1))
                    ).numpy()[0]
                    actions[agent] = a.item() if a.shape == () else a
                obs, rewards, terms, truncs, _ = env.step(actions)
                total += sum(rewards.values())
                done = terms.get("__all__", False) or truncs.get("__all__", False)
                obs = {a: o for a, o in obs.items()
                       if not (terms.get(a, False) or truncs.get(a, False))}
            returns.append(total)
        env.close()
        return {
            "episode_return_mean": float(np.mean(returns)),
            "num_episodes": len(returns),
        }

    # -- checkpointing ----------------------------------------------------
    def _state(self) -> dict:
        return {
            "learner": self.learner_group.get_state(),
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def _set_state(self, state: dict) -> None:
        self.learner_group.set_state(state["learner"])
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def save(self, checkpoint_dir: str | None = None) -> str:
        checkpoint_dir = checkpoint_dir or os.path.join(
            os.path.expanduser("~/ray_tpu_results"),
            f"{type(self).__name__.lower()}_ckpt_{self.iteration}",
        )
        os.makedirs(checkpoint_dir, exist_ok=True)
        state = {**self._state(), "config": self.config.to_dict(),
                 "algo_class": type(self).__name__}
        _atomic_write_pickle(os.path.join(checkpoint_dir, "algorithm_state.pkl"), state)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            self._set_state(pickle.load(f))

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, config: AlgorithmConfig, device=None):
        algo = config.build_algo(device=device)
        algo.restore(checkpoint_dir)
        return algo

    # tune.Trainable duck-type
    def save_checkpoint(self) -> Any:
        return pickle.dumps(self._state())

    def load_checkpoint(self, blob: Any) -> None:
        self._set_state(pickle.loads(blob))

    def stop(self) -> None:
        self.env_runner_group.stop()
        self.learner_group.stop()
