"""EnvRunnerGroup — the fleet of rollout workers.

Port of ray_tpu's ``rllib/env/env_runner_group.py``. The reference spawns
``num_env_runners`` ``ray_tpu.remote`` actors (``num_cpus=1`` each); the
port has no actor runtime (ROADMAP Queue A item 4), so each runner lives in
a CPU process of a ``util.gang.WorkerGang(n, use_gpu=False)``, in that
member's state, which persists between ``run`` calls. Each process runs
one torch thread, as an actor of one CPU would, so the runners and the
learner do not oversubscribe the host. ``sample`` fans out to every runner
at once and waits for all (PPO's synchronous path); ``sync_weights``
sends the learner's numpy weights to each.

What a runner is built from crosses a process boundary, so the env
creator, module spec and connector factories must pickle (module-level
functions and classes). The asynchronous pipeline (``sample_async`` /
``collect_ready``, IMPALA's) and multi-agent runners wait for ROADMAP
Queue A item 7b.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np

from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


def _runner_start(ctx, env_creator, module_spec, kwargs: dict) -> str:
    import torch

    torch.set_num_threads(1)
    ctx.state["runner"] = SingleAgentEnvRunner(env_creator, module_spec, **kwargs)
    return "ok"


def _runner_call(ctx, method: str, *args):
    return getattr(ctx.state["runner"], method)(*args)


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
        from ray_tpu_torch.util.gang import WorkerGang

        if runner_class not in (None, SingleAgentEnvRunner) or runner_kwargs:
            raise NotImplementedError(
                "multi-agent env runners wait for ROADMAP Queue A item 7b")
        self.num_env_runners = max(1, num_env_runners)
        self._gang = WorkerGang(self.num_env_runners, use_gpu=False)
        try:
            self._gang.run(_runner_start, per_rank_args=[
                (env_creator, module_spec, dict(
                    num_envs=num_envs_per_runner,
                    rollout_fragment_length=rollout_fragment_length,
                    worker_index=i, seed=seed, env_to_module=env_to_module,
                    module_to_env=module_to_env))
                for i in range(self.num_env_runners)
            ], timeout=180)
        except BaseException:
            self._gang.shutdown()
            raise

    def _all(self, method: str, *args, timeout: float = 120) -> list:
        return self._gang.run(_runner_call,
                              per_rank_args=[(method, *args)] * self.num_env_runners,
                              timeout=timeout)

    def sync_weights(self, params) -> None:
        self._all("set_weights", params)

    def sample(self) -> SampleBatch:
        """Synchronous fan-out (PPO path)."""
        return SampleBatch.concat_samples(self._all("sample", timeout=600))

    # -- async pipeline (IMPALA path) -----------------------------------
    def sample_async(self) -> None:
        raise NotImplementedError(
            "the asynchronous sampling pipeline (IMPALA's) waits for ROADMAP Queue A item 7b")

    def collect_ready(self, timeout: float = 0.05) -> list[SampleBatch]:
        raise NotImplementedError(
            "the asynchronous sampling pipeline (IMPALA's) waits for ROADMAP Queue A item 7b")

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
        self._gang.shutdown()
