"""APPO — asynchronous PPO: IMPALA's pipeline + PPO's clipped surrogate.

Port of ray_tpu's ``rllib/algorithms/appo/appo.py``: env runners sample
continuously (the IMPALA async harvest), V-trace corrects the
off-policyness of stale fragments, and the policy update applies the PPO
clipped surrogate over the V-trace advantages. The reference APPO's
stabilizers are both here:

  * a TARGET NETWORK — a copy of the policy synced every
    ``target_network_update_freq`` updates, which anchors the KL term;
  * an ADAPTIVE KL LOSS (``use_kl_loss``/``kl_coeff``/``kl_target``) —
    KL(target || current) joins the loss; the coefficient grows 1.5x when
    the measured KL exceeds 2x target and halves below 0.5x target. In
    multi-learner DP mode the KL term and the target sync stay active on
    the gradient path, and the coefficient keeps its configured value.

The target network's distribution is computed by a forward under
``torch.no_grad`` on the learner's device and joins the device batch
(``target_logits`` or ``target_mean`` / ``target_log_std``, and
``kl_coeff``) before the loss, as the reference injects it into its batch.
The loss runs the current network's forward once for the log-likelihood
and the KL term.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALA, IMPALAConfig, IMPALALearner
from ray_tpu_torch.rllib.core.learner import _clone, _numpy, _tensors
from ray_tpu_torch.rllib.policy.sample_batch import ACTION_LOGP, ACTIONS, OBS


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self.clip_param: float = 0.3
        self.lr = 5e-4
        self.use_kl_loss: bool = True
        self.kl_coeff: float = 0.2
        self.kl_target: float = 0.01
        self.target_network_update_freq: int = 4  # learner updates / sync


class APPOLearner(IMPALALearner):
    def __init__(self, module, config: dict, seed: int = 0, *, device=None):
        super().__init__(module, config, seed, device=device)
        self._use_kl = bool(config.get("use_kl_loss", True))
        self._updates_since_sync = 0
        self._kl_coeff = float(config.get("kl_coeff", 0.2))
        self.target_params = _clone(self.params) if self._use_kl else None

    def _device_batch(self, batch) -> dict:
        """The batch on the device with the target network's distribution
        and the current KL coefficient as constants: shared by ``update``
        and the DP-mode ``compute_gradients``."""
        out = super()._device_batch(batch)
        if self._use_kl:
            with torch.no_grad():
                target_out = self.module.forward_train(self.target_params, out[OBS])
            if "logits" in target_out:
                out["target_logits"] = target_out["logits"]
            else:
                out["target_mean"] = target_out["mean"]
                out["target_log_std"] = target_out["log_std"]
            out["kl_coeff"] = torch.full((1,), self._kl_coeff, device=self.device)
        return out

    def _maybe_sync_target(self) -> None:
        self._updates_since_sync += 1
        if self._updates_since_sync >= self.config.get("target_network_update_freq", 4):
            self._updates_since_sync = 0
            self.target_params = _clone(self.params)

    def compute_loss(self, params, batch: dict):
        cfg = self.config
        current = self.module.forward_train(params, batch[OBS])
        logp, entropy, vf = self.module._logp_entropy(current, batch[ACTIONS])
        vs, pg_adv = self._vtrace(batch, logp, vf)
        # PPO clipped surrogate over the V-trace advantages (the APPO
        # twist: bounded policy steps on asynchronous data).
        clip = cfg.get("clip_param", 0.3)
        ratio = torch.exp(logp - batch[ACTION_LOGP])
        surrogate = torch.minimum(ratio * pg_adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * pg_adv)
        policy_loss = -torch.mean(surrogate)
        vf_loss = 0.5 * torch.mean((vf - vs) ** 2)
        entropy_mean = torch.mean(entropy)
        total = (
            policy_loss
            + cfg.get("vf_loss_coeff", 0.5) * vf_loss
            - cfg.get("entropy_coeff", 0.01) * entropy_mean
        )
        metrics = {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy_mean,
            "mean_ratio": torch.mean(ratio),
        }
        if "target_logits" in batch:
            # KL(target || current) over the batch states (discrete)
            target = batch["target_logits"]
            p_t = torch.softmax(target, dim=-1)
            kl = torch.mean(torch.sum(
                p_t * (torch.log_softmax(target, dim=-1)
                       - torch.log_softmax(current["logits"], dim=-1)), dim=-1))
            total = total + batch["kl_coeff"][0] * kl
            metrics["kl"] = kl
        elif "target_mean" in batch:
            # diagonal-gaussian KL(target || current)
            t_mean, t_log_std = batch["target_mean"], batch["target_log_std"]
            c_mean, c_log_std = current["mean"], current["log_std"]
            kl = torch.mean(torch.sum(
                c_log_std - t_log_std
                + (torch.exp(2 * t_log_std) + (t_mean - c_mean) ** 2)
                / (2 * torch.exp(2 * c_log_std))
                - 0.5, dim=-1))
            total = total + batch["kl_coeff"][0] * kl
            metrics["kl"] = kl
        return total, metrics

    def update(self, batch) -> dict:
        cfg = self.config
        metrics = super().update(batch)
        if "kl" in metrics:
            # reference adaptive schedule: grow 1.5x / halve outside the
            # [0.5, 2] x target band
            kl = metrics["kl"]
            target = cfg.get("kl_target", 0.01)
            if kl > 2.0 * target:
                self._kl_coeff = min(self._kl_coeff * 1.5, 1e3)
            elif kl < 0.5 * target:
                self._kl_coeff = max(self._kl_coeff * 0.5, 1e-6)
            metrics["kl_coeff"] = self._kl_coeff
        if self._use_kl:
            self._maybe_sync_target()
        return metrics

    # DP mode (num_learners >= 2): shards flow through compute_gradients
    # (whose device batch carries the target) and apply_gradients.
    def apply_gradients(self, grads) -> None:
        super().apply_gradients(grads)
        if self._use_kl:
            self._maybe_sync_target()

    def get_state(self) -> dict:
        state = super().get_state()
        if self._use_kl:
            state["target_params"] = _numpy(self.target_params)
        state["kl_coeff"] = self._kl_coeff
        state["updates_since_sync"] = self._updates_since_sync
        return state

    def set_state(self, state: dict) -> None:
        super().set_state(state)
        if self._use_kl:
            if "target_params" in state:
                self.target_params = _tensors(state["target_params"], self.device)
            else:
                # base-Learner-shaped checkpoint: anchor the target to the
                # restored params rather than keeping fresh-init values
                # (which would read as a huge KL until the first sync)
                self.target_params = _clone(self.params)
        self._kl_coeff = float(state.get("kl_coeff", self._kl_coeff))
        self._updates_since_sync = int(state.get("updates_since_sync", 0))


class APPO(IMPALA):
    learner_class = APPOLearner

    def _learner_config(self) -> dict:
        cfg = super()._learner_config()
        cfg.update(
            clip_param=self.config.clip_param,
            use_kl_loss=self.config.use_kl_loss,
            kl_coeff=self.config.kl_coeff,
            kl_target=self.config.kl_target,
            target_network_update_freq=self.config.target_network_update_freq,
        )
        return cfg
