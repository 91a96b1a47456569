"""EnvRunnerGroup — the fleet of rollout workers.

Port of ray_tpu's ``rllib/env/env_runner_group.py``. The reference spawns
``num_env_runners`` ``ray_tpu.remote`` actors (``num_cpus=1`` each); the
port has no actor runtime (ROADMAP Queue A item 4), so each runner lives in
a CPU process of a ``util.gang.WorkerGang(n, use_gpu=False)``, in that
member's state, which persists between ``run`` calls. Each process runs
one torch thread, as an actor of one CPU would, so the runners and the
learner do not oversubscribe the host. ``sample`` fans out to every runner
at once and waits for all (PPO's synchronous path); ``sync_weights``
sends the learner's numpy weights to each. ``runner_class`` picks the
runner (``SingleAgentEnvRunner`` by default, ``MultiAgentEnvRunner`` for
multi-agent configs), built with ``runner_kwargs`` on top of the common
arguments.

The asynchronous pipeline (IMPALA's): ``sample_async`` posts a ``sample``
to every idle runner (``WorkerGang.send``) and returns; ``collect_ready``
harvests the replies that arrive within its timeout (``recv_any``) and
posts the next ``sample`` to each runner that answered. A runner's pipe
carries one reply a request, in order, with no tag, so a fan-out (``_all``:
weights, epsilon, metrics) first drains the samples in flight and keeps
them for the next ``collect_ready``. That is the reference's timing too:
its actors run calls one at a time, so ``set_weights`` waits behind the
runner's ``sample``.

What a runner is built from crosses a process boundary, so the env
creator, module spec, connector factories and ``runner_kwargs`` (a
``policy_mapping_fn``) must pickle (module-level functions and classes).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Optional

import numpy as np

from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch


def _runner_start(ctx, runner_class, env_creator, module_spec, kwargs: dict) -> str:
    import torch

    torch.set_num_threads(1)
    ctx.state["runner"] = runner_class(env_creator, module_spec, **kwargs)
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

        self.num_env_runners = max(1, num_env_runners)
        self._gang = WorkerGang(self.num_env_runners, use_gpu=False)
        # Async pipeline: ranks with a ``sample`` posted and not yet read,
        # and replies drained before a fan-out, kept for collect_ready.
        self._inflight: set[int] = set()
        self._drained: dict[int, Any] = {}
        try:
            self._gang.run(_runner_start, per_rank_args=[
                (runner_class or SingleAgentEnvRunner, env_creator, module_spec, dict(
                    num_envs=num_envs_per_runner,
                    rollout_fragment_length=rollout_fragment_length,
                    worker_index=i, seed=seed, env_to_module=env_to_module,
                    module_to_env=module_to_env, **(runner_kwargs or {})))
                for i in range(self.num_env_runners)
            ], timeout=180)
        except BaseException:
            self._gang.shutdown()
            raise

    def _all(self, method: str, *args, timeout: float = 120) -> list:
        self._drain()
        return self._gang.run(_runner_call,
                              per_rank_args=[(method, *args)] * self.num_env_runners,
                              timeout=timeout)

    def sync_weights(self, params) -> None:
        self._all("set_weights", params)

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
    def _post_sample(self, rank: int) -> None:
        self._gang.send(rank, ("run", _runner_call, ("sample",), {}, None))
        self._inflight.add(rank)

    def _reply(self, rank: int, message):
        kind, *body = message
        if kind == "error":
            from ray_tpu_torch.util.gang import WorkerError

            raise WorkerError(rank, body[0], body[1])
        return body[0]

    def _drain(self, timeout: float = 600) -> None:
        """Reads every sample in flight; the replies wait in ``_drained``."""
        while self._inflight:
            rank, message = self._gang.recv_any(sorted(self._inflight), timeout=timeout)
            self._inflight.discard(rank)
            self._drained[rank] = self._reply(rank, message)

    def sample_async(self) -> None:
        for rank in range(self.num_env_runners):
            if rank not in self._inflight and rank not in self._drained:
                self._post_sample(rank)

    def collect_ready(self, timeout: float = 0.05) -> list[SampleBatch]:
        """Harvest finished rollouts; immediately resubmit those runners."""
        if not self._inflight and not self._drained:
            self.sample_async()
        pending = set(self._inflight)  # waited for up to ``timeout``
        out = []
        for rank in sorted(self._drained):
            out.append(self._drained.pop(rank))
            self._post_sample(rank)
        deadline = time.monotonic() + timeout
        while pending:
            try:
                rank, message = self._gang.recv_any(
                    sorted(pending), timeout=max(0.0, deadline - time.monotonic()))
            except TimeoutError:
                break
            pending.discard(rank)
            self._inflight.discard(rank)
            try:
                out.append(self._reply(rank, message))
            finally:
                self._post_sample(rank)
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
        self._gang.shutdown()
