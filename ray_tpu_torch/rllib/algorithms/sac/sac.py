"""SAC — soft actor-critic (continuous control, off-policy).

Port of ray_tpu's ``rllib/algorithms/sac/sac.py``: a squashed-gaussian
actor, twin Q critics with polyak-averaged targets and automatic
temperature tuning against a target entropy. One update runs the critic,
actor and temperature losses as one total, its gradient, the global-norm
clip and Adam over the whole tree (``log_alpha`` included;
``Learner._apply``), then the polyak step ``(1 - tau) * t + tau * o`` on
the target towers, all on the learner's device.

Where gradients stop, as the reference's stop-gradients place them: the
critic target (the next state's sampled action and the target towers) is
computed under ``torch.no_grad``; the actor's Q value runs the towers on
detached copies of their leaves, so its gradient reaches ``pi`` through
the sampled action and never the critics; ``alpha`` is detached
everywhere but the temperature loss.

JAX's PRNG cannot be reproduced in torch, so the step takes its noise as
tensors: the standard normals of the actor's and the next state's
sampled actions (and CQL's uniform and per-sample normals). ``update``
draws them from the learner's ``torch.Generator`` on its device, or takes
them from the caller (``noise=``), which is how a test hands both packages
one draw.

The tree is ``{"pi", "q1", "q2", "log_alpha"}`` and the targets
``{"q1", "q2"}``, matched by key, never by leaf order.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.models.convert import _map
from ray_tpu_torch.rllib.core.learner import Learner, _clone, _numpy, _paired_leaves, _tensors
from ray_tpu_torch.rllib.core.rl_module import (
    RLModule, RLModuleSpec, _generator, _LOG_2PI, _mlp_apply, _mlp_init, _to,
)
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS, NEXT_OBS, OBS, REWARDS, SampleBatch, TERMINATEDS,
)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self.lr = 3e-4
        self.train_batch_size = 256
        self.replay_buffer_capacity: int = 100_000
        self.num_steps_sampled_before_learning_starts: int = 1000
        self.tau: float = 0.005  # polyak coefficient
        self.target_entropy: float | str = "auto"  # auto → -act_dim
        self.initial_alpha: float = 1.0
        self.updates_per_iteration: int = 200
        self.rollout_fragment_length = 25
        self.num_envs_per_env_runner = 8
        self.num_env_runners = 1


class SACModule(RLModule):
    """Squashed-gaussian policy + twin Q towers (ReLU MLPs).

    Actions leave the module already tanh-squashed and scaled into the
    env's Box bounds, so the runner's ClipActions connector is a no-op and
    replayed ACTIONS feed the critics unchanged.
    """

    def __init__(self, observation_space, action_space, model_config, device=None):
        super().__init__(observation_space, action_space, model_config, device)
        if not hasattr(action_space, "low"):
            raise ValueError("SAC requires a Box action space")
        self.hiddens = tuple(model_config.get("fcnet_hiddens", (256, 256)))
        self.obs_dim = int(np.prod(observation_space.shape))
        self.act_dim = int(np.prod(action_space.shape))
        low = np.asarray(action_space.low, dtype=np.float32).reshape(-1)
        high = np.asarray(action_space.high, dtype=np.float32).reshape(-1)
        self._box = torch.from_numpy(np.stack([(high - low) / 2.0, (high + low) / 2.0]))
        self._box_on: dict = {}
        self.discrete = False

    def init_params(self, seed=0, device=None) -> dict:
        gen = _generator(seed)
        q_sizes = (self.obs_dim + self.act_dim, *self.hiddens, 1)
        params = {
            "pi": _mlp_init(gen, (self.obs_dim, *self.hiddens, 2 * self.act_dim)),
            "q1": _mlp_init(gen, q_sizes),
            "q2": _mlp_init(gen, q_sizes),
            "log_alpha": torch.zeros(()),
        }
        return _to(params, device or self.device)

    def bounds(self, like: torch.Tensor) -> tuple:
        """(scale, center) of the action box on ``like``'s device (copied
        there once)."""
        if like.device not in self._box_on:
            self._box_on[like.device] = self._box.to(like.device)
        box = self._box_on[like.device]
        return box[0], box[1]

    # -- policy ----------------------------------------------------------
    def _pi_dist(self, pi_params, obs):
        obs = obs.reshape(obs.shape[0], -1).float()
        out = _mlp_apply(pi_params, obs, activation=torch.relu)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def sample_action(self, pi_params, obs, noise):
        """→ (env-scaled actions, logp) with the tanh-squash correction, for
        standard-normal ``noise`` of the actions' shape."""
        mean, log_std = self._pi_dist(pi_params, obs)
        std = torch.exp(log_std)
        u = mean + std * noise
        gauss_logp = -0.5 * torch.sum(((u - mean) / std) ** 2 + 2 * log_std + _LOG_2PI, dim=-1)
        a = torch.tanh(u)
        # d tanh correction: log det Jacobian of the squash
        logp = gauss_logp - torch.sum(torch.log(1.0 - a**2 + 1e-6), dim=-1)
        scale, center = self.bounds(a)
        return a * scale + center, logp

    def q_values(self, q_params, obs, actions):
        obs = obs.reshape(obs.shape[0], -1).float()
        x = torch.cat([obs, actions.reshape(obs.shape[0], -1)], dim=-1)
        return _mlp_apply(q_params, x, activation=torch.relu)[..., 0]

    # -- RLModule surface (env runner hooks) -----------------------------
    def forward_exploration(self, params, obs, generator):
        noise = torch.randn((obs.shape[0], self.act_dim), generator=generator, device=obs.device)
        actions, logp = self.sample_action(params["pi"], obs, noise)
        return actions, logp, {"vf_preds": actions.new_zeros(actions.shape[0])}

    def forward_inference(self, params, obs):
        mean, _ = self._pi_dist(params["pi"], obs)
        scale, center = self.bounds(mean)
        return torch.tanh(mean) * scale + center

    def forward_train(self, params, obs) -> dict:
        mean, log_std = self._pi_dist(params["pi"], obs)
        return {"mean": mean, "log_std": log_std, "vf": mean.new_zeros(mean.shape[0])}


def _detached(tree):
    """The same leaves, cut from autograd (the reference's
    ``stop_gradient(p[...])``)."""
    return _map(lambda t, _: t.detach(), tree)


class SACLearner(Learner):
    """One step: critic + actor + alpha losses, one backward, polyak targets."""

    def __init__(self, module: SACModule, config: dict, seed: int = 0, *, device=None):
        super().__init__(module, config, seed, device=device)
        self.target_params = _clone({"q1": self.params["q1"], "q2": self.params["q2"]})
        if config.get("initial_alpha") is not None:
            # The reference re-initialises its optax state here; Adam holds
            # no state before its first step.
            with torch.no_grad():
                self.params["log_alpha"].fill_(float(np.log(config["initial_alpha"])))
        target_entropy = config.get("target_entropy", "auto")
        self._target_entropy = (
            -float(module.act_dim) if target_entropy in (None, "auto") else float(target_entropy)
        )
        self._gen = torch.Generator(device=self.device).manual_seed(seed * 7919 + 13)

    def compute_loss(self, params, batch):
        raise NotImplementedError("SACLearner runs its own combined step (update)")

    # -- noise -----------------------------------------------------------
    def _normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen, device=self.device)

    def draw_noise(self, rows: int) -> dict:
        """The step's random draws: the standard normals of the actor's and
        the next state's sampled actions."""
        return {"actor": self._normal(rows, self.module.act_dim),
                "next": self._normal(rows, self.module.act_dim)}

    def _critic_regularizer(self, p, batch, noise, q1_data, q2_data):
        """Extra critic-loss term: SAC adds nothing; CQL overrides with the
        conservative penalty."""
        return 0.0, {}

    def sac_loss(self, p, batch: dict, noise: dict) -> tuple:
        module: SACModule = self.module
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        obs, actions = batch[OBS], batch[ACTIONS]
        not_done = 1.0 - batch[TERMINATEDS].float()
        alpha = torch.exp(p["log_alpha"])
        alpha_sg = alpha.detach()
        # -- critic target (no gradient anywhere inside)
        with torch.no_grad():
            a_next, logp_next = module.sample_action(p["pi"], batch[NEXT_OBS], noise["next"])
            q_next = torch.minimum(
                module.q_values(self.target_params["q1"], batch[NEXT_OBS], a_next),
                module.q_values(self.target_params["q2"], batch[NEXT_OBS], a_next),
            )
            target = batch[REWARDS] + gamma * not_done * (q_next - alpha_sg * logp_next)
        q1 = module.q_values(p["q1"], obs, actions)
        q2 = module.q_values(p["q2"], obs, actions)
        critic_loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)
        # Critic regularizer hook: zero for SAC; CQL adds the conservative
        # penalty here.
        reg_loss, reg_metrics = self._critic_regularizer(p, batch, noise, q1, q2)
        critic_loss = critic_loss + reg_loss
        # -- actor (gradient to pi only: the towers run on detached leaves)
        a_pi, logp_pi = module.sample_action(p["pi"], obs, noise["actor"])
        frozen = _detached({"q1": p["q1"], "q2": p["q2"]})
        q_pi = torch.minimum(module.q_values(frozen["q1"], obs, a_pi),
                             module.q_values(frozen["q2"], obs, a_pi))
        actor_loss = torch.mean(alpha_sg * logp_pi - q_pi)
        # -- temperature
        alpha_loss = -torch.mean(p["log_alpha"] * (logp_pi + self._target_entropy).detach())
        total = critic_loss + actor_loss + alpha_loss
        return total, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha_loss": alpha_loss,
            "alpha": alpha,
            "entropy": -torch.mean(logp_pi),
            "q_mean": torch.mean(q1),
            **reg_metrics,
        }

    def _polyak(self) -> None:
        """targets <- (1 - tau) * targets + tau * online, leaf by leaf."""
        tau = self.config.get("tau", 0.005)
        targets, online = _paired_leaves(self.target_params, self.params)
        with torch.no_grad():
            torch._foreach_mul_(targets, 1.0 - tau)
            torch._foreach_add_(targets, torch._foreach_mul(online, tau))

    def _inputs(self, batch: SampleBatch, noise: dict | None) -> tuple:
        """(device batch, noise on the device): the caller's noise, or a
        draw from the learner's generator."""
        columns = (OBS, ACTIONS, REWARDS, NEXT_OBS, TERMINATEDS)
        device_batch = self._to_device(SampleBatch({k: batch[k] for k in columns}))
        if noise is None:
            return device_batch, self.draw_noise(device_batch[OBS].shape[0])
        return device_batch, {k: torch.as_tensor(np.array(v, np.float32)).to(self.device)
                              for k, v in noise.items()}

    def compute_gradients(self, batch: SampleBatch, noise: dict | None = None) -> list:
        """The total loss's gradient, one tensor a leaf (``named_leaves`` order)."""
        loss, _ = self.sac_loss(self.params, *self._inputs(batch, noise))
        return list(torch.autograd.grad(loss, self._leaves, allow_unused=True,
                                        materialize_grads=True))

    def update(self, batch: SampleBatch, noise: dict | None = None) -> dict:
        loss, metrics = self.sac_loss(self.params, *self._inputs(batch, noise))
        loss.backward()
        self._apply()
        self._polyak()
        metrics["total_loss"] = loss
        return self._floats(metrics)

    def get_state(self) -> dict:
        state = super().get_state()
        state["target_params"] = _numpy(self.target_params)
        return state

    def set_state(self, state: dict) -> None:
        super().set_state(state)
        if "target_params" in state:
            self.target_params = _tensors(state["target_params"], self.device)


class SAC(Algorithm):
    learner_class = SACLearner

    def __init__(self, config: SACConfig, device=None):
        if config.rl_module_spec is None:
            config.rl_module_spec = RLModuleSpec(SACModule, dict(config.model))
        super().__init__(config, device=device)
        self.replay = ReplayBuffer(config.replay_buffer_capacity, seed=config.seed)

    def _learner_config(self) -> dict:
        cfg = super()._learner_config()
        cfg.update(
            tau=self.config.tau,
            target_entropy=self.config.target_entropy,
            initial_alpha=self.config.initial_alpha,
        )
        return cfg

    def training_step(self) -> dict:
        config = self.config
        fragment = self.env_runner_group.sample()
        self._total_env_steps += len(fragment)
        self.replay.add(fragment)
        metrics: dict = {"buffer_size": len(self.replay)}
        if len(self.replay) < config.num_steps_sampled_before_learning_starts:
            return metrics
        learner = self.learner_group.local_learner
        if learner is None:
            raise ValueError("SAC uses a local learner (num_learners=0)")
        for _ in range(config.updates_per_iteration):
            batch = self.replay.sample(config.train_batch_size)
            update_metrics = learner.update(batch)
        metrics.update(update_metrics)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return metrics

