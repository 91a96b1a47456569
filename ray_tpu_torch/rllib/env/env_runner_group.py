"""EnvRunnerGroup — the fleet of rollout workers.

Port of ray_tpu's ``rllib/env/env_runner_group.py``: ``num_env_runners``
runtime actors (``ray_tpu_torch.remote(runner_class).options(num_cpus=1)``),
so building a group needs ``ray_tpu_torch.init()`` first. Each runner's
process runs one torch thread (``OMP_NUM_THREADS=1`` in its environment),
as an actor of one CPU would, so the runners and the learner do not
oversubscribe the host. ``sample`` fans out to every runner at once and
waits for all (PPO's synchronous path); ``sync_weights`` puts the
learner's numpy weights in the object store once and hands each runner
the ref. ``runner_class`` picks the runner (``SingleAgentEnvRunner`` by
default, ``MultiAgentEnvRunner`` for multi-agent configs), built with
``runner_kwargs`` on top of the common arguments.

The asynchronous pipeline (IMPALA's): ``sample_async`` starts a
``sample`` on every idle runner and returns; ``collect_ready`` harvests
the samples that finish within its timeout (``ray_tpu_torch.wait``) and
starts the next ``sample`` on each runner that answered. An actor runs its
calls one at a time, so a fan-out (weights, epsilon, metrics) waits behind
a runner's ``sample`` in flight, as the reference's does; the samples it
waited behind are ready for the next ``collect_ready``.

What a runner is built from goes to its actor by module and qualified
name (``_private.code_ref``), so the env creator, module spec, connector
factories and ``runner_kwargs`` (a ``policy_mapping_fn``) must be defined
at module level.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private.code_ref import pack
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch


class EnvRunnerGroup:
    def __init__(
        self,
        env_creator: Any,
        module_spec,
        *,
        num_env_runners: int = 2,
        num_envs_per_runner: int = 1,
        rollout_fragment_length: int = 200,
        seed: Optional[int] = None,
        env_to_module: Any = None,
        module_to_env: Any = None,
        runner_class: Any = None,
        runner_kwargs: dict | None = None,
    ):
        runner_cls = ray_tpu_torch.remote(runner_class or SingleAgentEnvRunner)
        self.num_env_runners = max(1, num_env_runners)
        common = dict(num_envs=num_envs_per_runner,
                      rollout_fragment_length=rollout_fragment_length, seed=seed,
                      env_to_module=pack(env_to_module), module_to_env=pack(module_to_env),
                      **{k: pack(v) for k, v in (runner_kwargs or {}).items()})
        self.runners = [
            runner_cls.options(num_cpus=1, runtime_env={"env_vars": {"OMP_NUM_THREADS": "1"}})
            .remote(pack(env_creator), pack(module_spec), worker_index=i, **common)
            for i in range(self.num_env_runners)
        ]
        self._inflight: dict = {}
        try:
            ray_tpu_torch.get([r.ping.remote() for r in self.runners], timeout=180)
        except BaseException:
            self.stop()
            raise

    def _all(self, method: str, *args, timeout: float = 120) -> list:
        # An actor runs its calls in order, so the fan-out waits behind the
        # samples in flight; waiting for them here too makes them ready for
        # the next ``collect_ready``, however short its timeout.
        if self._inflight:
            ray_tpu_torch.wait(list(self._inflight.values()), num_returns=len(self._inflight),
                               timeout=timeout)
        return ray_tpu_torch.get([getattr(r, method).remote(*args) for r in self.runners],
                                 timeout=timeout)

    def sync_weights(self, params) -> None:
        self._all("set_weights", ray_tpu_torch.put(params))

    def set_epsilon(self, epsilon: Optional[float]) -> None:
        """Epsilon-greedy exploration in every runner (DQN)."""
        self._all("set_epsilon", epsilon)

    def sample(self) -> SampleBatch | MultiAgentBatch:
        """Synchronous fan-out (PPO path)."""
        batches = self._all("sample", timeout=600)
        if batches and isinstance(batches[0], MultiAgentBatch):
            return MultiAgentBatch.concat_samples(batches)
        return SampleBatch.concat_samples(batches)

    # -- async pipeline (IMPALA path) -----------------------------------
    def sample_async(self) -> None:
        for i, runner in enumerate(self.runners):
            if i not in self._inflight:
                self._inflight[i] = runner.sample.remote()

    def collect_ready(self, timeout: float = 0.05) -> list[SampleBatch]:
        """Harvest finished rollouts; immediately resubmit those runners."""
        if not self._inflight:
            self.sample_async()
        ref_to_idx = {ref: i for i, ref in self._inflight.items()}
        ready, _ = ray_tpu_torch.wait(list(ref_to_idx), num_returns=len(ref_to_idx),
                                      timeout=timeout)
        out = []
        # In runner order, whatever order they finished in: the learner's
        # updates then follow the same sequence run to run.
        for ref in sorted(ready, key=ref_to_idx.__getitem__):
            idx = ref_to_idx[ref]
            try:
                out.append(ray_tpu_torch.get(ref))
            finally:
                self._inflight[idx] = self.runners[idx].sample.remote()
        return out

    def get_connector_state(self) -> dict:
        """Running env→module connector state from runner 0 (the
        reference syncs connector state the same one-of-many way)."""
        try:
            return self._all("get_connector_state", timeout=60)[0]
        except Exception as exc:
            logging.getLogger(__name__).warning(
                "connector-state fetch from runner 0 failed (%s); "
                "evaluation will run with FRESH normalizer statistics",
                exc,
            )
            return {}

    def get_metrics(self) -> dict:
        metrics = self._all("get_metrics")
        returns = [
            m["episode_return_mean"]
            for m in metrics
            if not np.isnan(m.get("episode_return_mean", np.nan))
        ]
        lens = [
            m["episode_len_mean"]
            for m in metrics
            if not np.isnan(m.get("episode_len_mean", np.nan))
        ]
        return {
            "episode_return_mean": float(np.mean(returns)) if returns else np.nan,
            "episode_len_mean": float(np.mean(lens)) if lens else np.nan,
            "num_episodes": int(sum(m["num_episodes"] for m in metrics)),
        }

    def stop(self) -> None:
        for runner in self.runners:
            try:
                ray_tpu_torch.kill(runner)
            except ray_tpu_torch.exceptions.RayTpuError:
                pass  # the runner is already gone
