"""CQL — conservative Q-learning (offline continuous control).

Port of ray_tpu's ``rllib/algorithms/cql/cql.py``: SAC's
actor/critic/temperature step trained from an offline dataset, with the
CQL(H) conservative penalty on both critics,

    alpha_cql * ( E_s[ logsumexp_a Q(s, a) ] - E_(s,a)~D[ Q(s, a) ] )

where the logsumexp is estimated from ``cql_n_actions`` uniform-random
and as many current-policy actions a state, with importance correction.
The penalty rides SACLearner's ``_critic_regularizer`` hook inside the one
step on the learner's device.

Its noise comes with the step's: CQL adds ``rand_u`` (uniform in [-1, 1),
[n, B, act_dim]) and ``pi`` (standard normals of the n policy samples,
[n, B, act_dim]); the reference splits its key into the two and vmaps the
sampling over ``split(rng_pi, n)``. The port runs the n policy samples,
and each tower's 2n Q evaluations, as one batch of n·B (2n·B) rows.
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.rllib.algorithms.bc.bc import OfflineAlgorithm
from ray_tpu_torch.rllib.algorithms.sac.sac import SACConfig, SACLearner, SACModule
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS, NEXT_OBS, OBS, REWARDS, TERMINATEDS,
)


class CQLConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self.cql_alpha: float = 5.0
        self.cql_n_actions: int = 10
        self.updates_per_iteration = 100
        # offline: no rollout fleet, no replay warmup
        self.input_: object = None
        self.num_env_runners = 0
        self.num_steps_sampled_before_learning_starts = 0

    def offline_data(self, *, input_=None):
        if input_ is not None:
            self.input_ = input_
        return self

    def validate(self) -> None:
        super().validate()
        if self.input_ is None:
            raise ValueError("CQL needs config.offline_data(input_=...)")


class CQLLearner(SACLearner):
    def draw_noise(self, rows: int) -> dict:
        n = int(self.config.get("cql_n_actions", 10))
        noise = super().draw_noise(rows)
        shape = (n, rows, self.module.act_dim)
        noise["rand_u"] = torch.rand(shape, generator=self._gen, device=self.device) * 2.0 - 1.0
        noise["pi"] = self._normal(*shape)
        return noise

    def _critic_regularizer(self, p, batch, noise, q1_data, q2_data):
        module: SACModule = self.module
        cfg = self.config
        n = int(cfg.get("cql_n_actions", 10))
        alpha_cql = float(cfg.get("cql_alpha", 5.0))
        obs = batch[OBS]
        rows = obs.shape[0]
        act_dim = module.act_dim
        scale, center = module.bounds(obs)
        # OOD action set: n uniform-random + n current-policy actions.
        rand_actions = noise["rand_u"] * scale + center
        with torch.no_grad():
            pi_actions, pi_logp = module.sample_action(
                p["pi"], obs.repeat(n, *([1] * (obs.dim() - 1))),
                noise["pi"].reshape(n * rows, act_dim))
        actions = torch.cat([rand_actions, pi_actions.reshape(n, rows, act_dim)])
        # importance correction: uniform density over the action box
        log_unif = -torch.sum(torch.log(2.0 * scale))
        correction = torch.cat([log_unif.expand(n, rows), pi_logp.reshape(n, rows)])
        stacked_obs = obs.repeat(2 * n, *([1] * (obs.dim() - 1)))

        def penalty(q_params, q_data):
            q = module.q_values(q_params, stacked_obs,
                                actions.reshape(2 * n * rows, act_dim)).reshape(2 * n, rows)
            lse = torch.logsumexp(q - correction, dim=0) - math.log(2.0 * n)
            return torch.mean(lse) - torch.mean(q_data)

        gap1 = penalty(p["q1"], q1_data)
        gap2 = penalty(p["q2"], q2_data)
        reg = alpha_cql * (gap1 + gap2)
        return reg, {"cql_penalty": reg, "cql_gap": 0.5 * (gap1 + gap2)}


class CQL(OfflineAlgorithm):
    learner_class = CQLLearner
    required_columns = frozenset({OBS, ACTIONS, REWARDS, NEXT_OBS, TERMINATEDS})

    def __init__(self, config: CQLConfig, device=None):
        if config.rl_module_spec is None:
            config.rl_module_spec = RLModuleSpec(SACModule, dict(config.model))
        super().__init__(config, device=device)

    def _learner_config(self) -> dict:
        cfg = super()._learner_config()
        cfg.update(
            tau=self.config.tau,
            target_entropy=self.config.target_entropy,
            initial_alpha=self.config.initial_alpha,
            cql_alpha=self.config.cql_alpha,
            cql_n_actions=self.config.cql_n_actions,
        )
        return cfg
