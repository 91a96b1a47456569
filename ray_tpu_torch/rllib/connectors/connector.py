"""ConnectorV2 — composable observation/action/learner pipelines.

Role-equivalent of rllib/connectors/ :: ConnectorV2 and the per-role
pipelines (env→module, module→env, learner) from SURVEY §2.8. A connector
is a pure callable over a batch dict; pipelines compose them in order.
Env runners run the env→module pipeline on raw observations before the
module forward and the module→env pipeline on sampled actions before
``env.step``; algorithms run the learner pipeline (e.g. GAE) on collected
SampleBatches before the jitted update.

Connectors are plain Python/numpy on the rollout path (CPU-side) — the
learner connector's output feeds the learner's update on its device.

A copy of ray_tpu's ``rllib/connectors/connector.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import (
    ADVANTAGES, SampleBatch, VALUE_TARGETS,
)


class ConnectorV2:
    """One stage of a pipeline. Subclasses override __call__.

    ``batch`` is a dict (raw obs / action dicts on the env paths, a
    SampleBatch on the learner path). Extra context arrives as kwargs:
    ``module``, ``params``, ``spaces``, ``value_fn`` — connectors take
    what they need and ignore the rest.
    """

    # Stateful connectors carry per-stream state (framestacks, running
    # normalizers): callers that would need to run a batch through the
    # pipeline more than once per step must check this.
    stateful: bool = False

    def __call__(self, batch: Any, **kwargs) -> Any:
        raise NotImplementedError

    def get_state(self) -> dict:
        """Cross-episode state worth syncing between pipelines (running
        statistics). Per-episode state (framestack history) stays out."""
        return {}

    def set_state(self, state: dict) -> None:
        pass

    @property
    def name(self) -> str:
        return type(self).__name__


class ConnectorPipelineV2(ConnectorV2):
    """Ordered composition; also the container API (append/prepend/insert)."""

    def __init__(self, connectors: Iterable[ConnectorV2] = ()):  # noqa: D401
        self.connectors: list[ConnectorV2] = list(connectors)

    def __call__(self, batch: Any, **kwargs) -> Any:
        for connector in self.connectors:
            batch = connector(batch, **kwargs)
        return batch

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.insert(0, connector)
        return self

    def remove(self, name: str) -> "ConnectorPipelineV2":
        self.connectors = [c for c in self.connectors if c.name != name]
        return self

    def __getitem__(self, idx: int) -> ConnectorV2:
        return self.connectors[idx]

    def __len__(self) -> int:
        return len(self.connectors)

    @property
    def stateful(self) -> bool:  # type: ignore[override]
        return any(c.stateful for c in self.connectors)

    def get_state(self) -> dict:
        return {
            i: state
            for i, c in enumerate(self.connectors)
            if (state := c.get_state())
        }

    def set_state(self, state: dict) -> None:
        for i, sub in state.items():
            idx = int(i)
            if 0 <= idx < len(self.connectors):
                self.connectors[idx].set_state(sub)


# ---------------------------------------------------------------------------
# env → module
# ---------------------------------------------------------------------------
class FlattenObservations(ConnectorV2):
    """[B, ...] observations → [B, prod(...)] float32 (fcnet input).

    Image observations ([B, H, W, C]) pass through UNCHANGED — the vision
    net consumes them as pixels (and uint8 stays uint8 until the module's
    normalize, on the module's device), matching the reference where the flattener serves
    the fcnet path and conv inputs bypass it."""

    def __call__(self, batch, **kwargs):
        obs = np.asarray(batch)
        if obs.ndim >= 4:  # [B, H, W, C]: conv input, keep shape + dtype
            return obs
        return obs.reshape(obs.shape[0], -1).astype(np.float32, copy=False)


class NormalizeObservations(ConnectorV2):
    """Running mean/std normalization (per-runner statistics)."""

    stateful = True

    def __init__(self, epsilon: float = 1e-8, clip: float = 10.0):
        self.count = epsilon
        self.mean: Optional[np.ndarray] = None
        self.var: Optional[np.ndarray] = None
        self.clip = clip

    def __call__(self, batch, **kwargs):
        obs = np.asarray(batch, dtype=np.float32)
        flat = obs.reshape(obs.shape[0], -1)
        if self.mean is None:
            self.mean = np.zeros(flat.shape[1], dtype=np.float64)
            self.var = np.ones(flat.shape[1], dtype=np.float64)
        batch_mean = flat.mean(axis=0)
        batch_var = flat.var(axis=0)
        batch_count = flat.shape[0]
        delta = batch_mean - self.mean
        total = self.count + batch_count
        self.mean = self.mean + delta * batch_count / total
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + delta**2 * self.count * batch_count / total
        self.var = m2 / total
        self.count = total
        normalized = (flat - self.mean) / np.sqrt(self.var + 1e-8)
        return np.clip(normalized, -self.clip, self.clip).astype(np.float32)

    def get_state(self) -> dict:
        if self.mean is None:
            return {}
        return {
            "count": float(self.count),
            "mean": self.mean.copy(),
            "var": self.var.copy(),
        }

    def set_state(self, state: dict) -> None:
        if not state:
            return
        self.count = state["count"]
        self.mean = np.asarray(state["mean"], dtype=np.float64).copy()
        self.var = np.asarray(state["var"], dtype=np.float64).copy()


class FrameStack(ConnectorV2):
    """Stacks the last N observations along the feature axis.

    Episode boundaries: callers pass ``dones`` (bool mask per batch row of
    the PREVIOUS step) so a finished env's history is zeroed before its
    reset observation enters the stack — otherwise the first frames of a
    new episode would be stacked with the previous (dead) episode's tail.
    The env runner wires this automatically; a pipeline reused across
    episodes without dones (e.g. a hand-rolled eval loop) should call
    ``reset()`` between episodes.
    """

    stateful = True

    def __init__(self, num_frames: int = 4):
        self.num_frames = num_frames
        self._stack: list[np.ndarray] = []

    def reset(self) -> None:
        self._stack = []

    def __call__(self, batch, *, dones=None, **kwargs):
        obs = np.asarray(batch, dtype=np.float32)
        flat = obs.reshape(obs.shape[0], -1)
        if dones is not None and self._stack:
            done_idx = np.nonzero(np.asarray(dones))[0]
            if len(done_idx):
                for frame in self._stack:
                    frame[done_idx] = 0.0
        self._stack.append(flat)
        if len(self._stack) > self.num_frames:
            self._stack.pop(0)
        while len(self._stack) < self.num_frames:
            self._stack.insert(0, np.zeros_like(flat))
        return np.concatenate(self._stack, axis=-1)


# ---------------------------------------------------------------------------
# module → env
# ---------------------------------------------------------------------------
class ClipActions(ConnectorV2):
    """Clip continuous actions into the env's Box bounds (no-op discrete)."""

    def __call__(self, batch, *, action_space=None, **kwargs):
        if action_space is None or not hasattr(action_space, "low"):
            return batch
        return np.clip(
            np.asarray(batch), action_space.low, action_space.high
        )


# ---------------------------------------------------------------------------
# learner
# ---------------------------------------------------------------------------
class GeneralAdvantageEstimation(ConnectorV2):
    """GAE as a learner connector (reference: connectors/learner/
    general_advantage_estimation.py). Wraps the pure-numpy pass in
    utils/postprocessing.py; ``value_fn`` arrives from the algorithm."""

    def __init__(
        self, gamma: float = 0.99, lambda_: float = 0.95,
        standardize: bool = True,
    ):
        self.gamma = gamma
        self.lambda_ = lambda_
        self.standardize = standardize

    def __call__(self, batch: SampleBatch, *, value_fn=None, **kwargs):
        from ray_tpu_torch.rllib.utils.postprocessing import compute_gae

        if ADVANTAGES in batch and VALUE_TARGETS in batch:
            return batch
        return compute_gae(
            batch,
            gamma=self.gamma,
            lambda_=self.lambda_,
            value_fn=value_fn,
            standardize=self.standardize,
        )


class LambdaConnector(ConnectorV2):
    """Wrap a plain function as a connector stage."""

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self._name = name or getattr(fn, "__name__", "LambdaConnector")

    def __call__(self, batch, **kwargs):
        return self.fn(batch, **kwargs)

    @property
    def name(self) -> str:
        return self._name


def default_env_to_module() -> ConnectorPipelineV2:
    return ConnectorPipelineV2([FlattenObservations()])


def default_module_to_env() -> ConnectorPipelineV2:
    return ConnectorPipelineV2([ClipActions()])
