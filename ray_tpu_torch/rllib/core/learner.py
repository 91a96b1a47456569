"""Learner / LearnerGroup — the update, on the learner's device.

Port of ray_tpu's ``rllib/core/learner.py``. The reference jits loss,
gradients and optimizer into one XLA function with donated buffers; here
the update runs eagerly on the learner's device (cuda unless the caller
asks for the CPU) and updates the parameters in place after each
minibatch:

  * the optimizer is the reference's ``optax.chain(clip_by_global_norm(
    grad_clip), adam(lr))``: the gradients are left as they are when their
    global norm is below ``grad_clip`` and multiplied by clip / norm
    otherwise (optax's rule; ``torch.nn.utils.clip_grad_norm_`` divides by
    norm + 1e-6 and clamps, another result at the boundary), then
    ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, optax's
    ``adam``;
  * ``update`` returns Python floats, so it waits for the device once a
    minibatch, as the reference's does;
  * ``get_weights`` and ``get_state`` return numpy copies (the reference's
    ``jax.device_get``), so runners, checkpoints and tests see numpy. The
    state holds the params and Adam's moments and step count; ``set_state``
    restores the port's own state exactly.

Multi-learner data parallelism (``num_learners >= 1``): as the
reference's, the learners are ``_LearnerActor``s, runtime actors (a card
each on ``cuda``, a CPU each on the CPU), so the group needs
``ray_tpu_torch.init()`` first. Each joins a process group and its
collective group as a gang member does (``util.gang._GangMember``); a
shard's gradients are summed over that group (an ``NcclGroup`` on the
card, gloo on the CPU, where the reference's ``ring`` moves host copies:
the learners keep the device wire), divided by the world size, and
applied by every learner, as the reference's ``update_shard`` does.
``MultiAgentLearnerGroup`` keeps one local learner a module id, as the
reference's does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch._private.code_ref import pack
from ray_tpu_torch.models.convert import _map, load_optax_adam_state, optax_adam_state
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.train.step import named_leaves
from ray_tpu_torch.util.gang import _free_port, _GangMember


def _numpy(tree):
    """A tree of tensors -> numpy copies, on the host."""
    return _map(lambda t, _: np.array(t.detach().cpu()), tree)


def _clone(tree):
    """A detached copy of a tree of tensors (a target network)."""
    return _map(lambda t, _: t.detach().clone(), tree)


def _tensors(tree, device):
    return _map(lambda a, _: torch.as_tensor(np.asarray(a)).to(device), tree)


def _paired_leaves(dst, src) -> tuple[list, list]:
    """dst's leaves and the leaves of src at the same keys and indexes (src
    may hold more keys), in dst's order."""
    if isinstance(dst, dict):
        pairs = [_paired_leaves(dst[key], src[key]) for key in dst]
    elif isinstance(dst, list):
        pairs = [_paired_leaves(d, s) for d, s in zip(dst, src, strict=True)]
    else:
        return [dst], [src]
    return [x for p in pairs for x in p[0]], [x for p in pairs for x in p[1]]


def _copy_into(dst, src) -> None:
    """dst's leaves (tensors) <- src's, matched by key and index."""
    if isinstance(dst, dict):
        for key in dst:
            _copy_into(dst[key], src[key])
    elif isinstance(dst, list):
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)
    else:
        dst.copy_(torch.as_tensor(np.asarray(src)))


class Learner:
    """Owns params + optimizer; subclasses define compute_loss."""

    def __init__(self, module, config: dict, seed: int = 0, *, device=None):
        self.module = module
        self.config = dict(config)
        self.device = resolve_device(device)
        self.params = module.init_params(seed, device=self.device)
        self._leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(self.params)]
        self.grad_clip = self.config.get("grad_clip", 40.0)
        self.optimizer = torch.optim.Adam(self._leaves, lr=self.config.get("lr", 5e-4),
                                          betas=(0.9, 0.999), eps=1e-8)

    # -- subclass surface -----------------------------------------------
    def compute_loss(self, params, batch: dict) -> tuple[torch.Tensor, dict]:
        raise NotImplementedError

    # -- internals --------------------------------------------------------
    def _clip_gradients(self) -> None:
        """optax.clip_by_global_norm: the gradients as they are where their
        global norm is below grad_clip, else times grad_clip / norm. One
        multi-tensor norm and one multi-tensor multiply (by exactly 1.0
        below the clip), whatever the number of leaves."""
        grads = [leaf.grad for leaf in self._leaves]
        norm = torch.nn.utils.get_total_norm(grads)
        scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)

    def _apply(self) -> None:
        """Clip the gradients the leaves hold, step Adam, drop them. A leaf
        the loss does not reach gets a zero gradient, as under optax."""
        for leaf in self._leaves:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        self._clip_gradients()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    # -- public ----------------------------------------------------------
    def _to_device(self, batch: SampleBatch) -> dict:
        # Non-numeric bookkeeping columns (AGENT_ID strings, …) stay host-side;
        # f64 columns become f32, as jnp.asarray makes them; uint8 images
        # travel as uint8.
        out = {}
        for key, value in batch.items():
            array = np.asarray(value)
            if array.dtype.kind not in "biuf":
                continue
            t = torch.from_numpy(np.ascontiguousarray(array))
            if t.dtype == torch.float64:
                t = t.float()
            out[key] = t.to(self.device)
        return out

    def _device_batch(self, batch: SampleBatch) -> dict:
        """What ``compute_loss`` reads: the batch on the device, plus what a
        subclass adds (a target network's outputs, its params)."""
        return self._to_device(batch)

    @staticmethod
    def _floats(metrics: dict) -> dict:
        """Scalar metric tensors -> Python floats, in one copy from the device."""
        values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    def update(self, batch: SampleBatch) -> dict:
        loss, metrics = self.compute_loss(self.params, self._device_batch(batch))
        loss.backward()
        self._apply()
        metrics["total_loss"] = loss
        return self._floats(metrics)

    def compute_gradients(self, batch: SampleBatch) -> list:
        """The loss's gradient, one tensor a leaf (``named_leaves`` order)."""
        loss, _ = self.compute_loss(self.params, self._device_batch(batch))
        return list(torch.autograd.grad(loss, self._leaves, allow_unused=True,
                                        materialize_grads=True))

    def apply_gradients(self, grads) -> None:
        for leaf, g in zip(self._leaves, grads):
            leaf.grad = torch.as_tensor(g).to(self.device, leaf.dtype)
        self._apply()

    def get_weights(self):
        return _numpy(self.params)

    def set_weights(self, params) -> None:
        """Copies ``params`` (numpy or tensors, the port's layout) into the
        leaves in place: the optimizer keeps its hold on them."""
        with torch.no_grad():
            _copy_into(self.params, params)

    def get_state(self) -> dict:
        adam = optax_adam_state(self.optimizer, self.params)[0]
        return {
            "params": self.get_weights(),
            "opt_state": {"count": int(adam["count"]), "mu": _numpy(adam["mu"]),
                          "nu": _numpy(adam["nu"])},
        }

    def set_state(self, state: dict) -> None:
        self.set_weights(state["params"])
        opt = state["opt_state"]
        adam = {"count": opt["count"], "mu": _tensors(opt["mu"], "cpu"),
                "nu": _tensors(opt["nu"], "cpu")}
        load_optax_adam_state(self.optimizer, self.params, (adam,))


class _LearnerActor(_GangMember):
    """Hosts one Learner shard for multi-learner DP, on its lease's card
    (or the CPU), in a collective group of ``world_size`` learners."""

    def __init__(self, learner_cls, module_spec, obs_space, act_space, config: dict,
                 rank: int, world_size: int, group_name: str, master_port: int, use_gpu: bool):
        backend = "nccl" if use_gpu else "gloo"
        super().__init__(rank, world_size, group_name, backend, backend, master_port,
                         use_gpu, None)
        if self._start_error is None:
            device = self.gang_ctx.device
            self.learner: Learner = learner_cls(
                module_spec.build(obs_space, act_space, device=device), config, seed=0,
                device=device)

    def update_shard(self, batch: SampleBatch) -> dict:
        """DDP step: local grads → all-reduce (sum) / world size → apply."""
        ctx = self.gang_ctx
        if ctx.world_size == 1:
            return self.learner.update(batch)
        group = ctx.collective()
        grads = [group.allreduce(g) / ctx.world_size
                 for g in self.learner.compute_gradients(batch)]
        self.learner.apply_gradients(grads)
        return {"total_loss": float("nan")}

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, params) -> str:
        self.learner.set_weights(params)
        return "ok"

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, state) -> str:
        self.learner.set_state(state)
        return "ok"


class LearnerGroup:
    """num_learners=0 → local in-process learner on ``device`` (default).
    num_learners>=1 → learner actors with DP gradient all-reduce."""

    def __init__(
        self,
        learner_cls,
        module_spec,
        observation_space,
        action_space,
        config: dict,
        num_learners: int = 0,
        device=None,
    ):
        self.num_learners = num_learners
        self.device = resolve_device(device)
        self.actors = []
        if num_learners == 0:
            module = module_spec.build(observation_space, action_space, device=self.device)
            self.local_learner: Optional[Learner] = learner_cls(module, config, device=self.device)
        else:
            import ray_tpu_torch

            self.local_learner = None
            use_gpu = self.device.type == "cuda"
            actor_cls = ray_tpu_torch.remote(_LearnerActor)
            group_name = f"learner-dp-{os.urandom(4).hex()}"
            port = _free_port()
            args = [pack(a) for a in (learner_cls, module_spec, observation_space, action_space,
                                      config)]
            self.actors = [
                actor_cls.options(num_cpus=1, num_gpus=1 if use_gpu else 0).remote(
                    *args, rank, num_learners, group_name, port, use_gpu)
                for rank in range(num_learners)]
            try:
                ray_tpu_torch.get([a.ping.remote() for a in self.actors], timeout=180)
            except BaseException:
                self.stop()
                raise

    def _all(self, method: str, *args, timeout: float = 120) -> list:
        import ray_tpu_torch

        return ray_tpu_torch.get([getattr(a, method).remote(*args) for a in self.actors],
                                 timeout=timeout)

    def update(self, batch: SampleBatch) -> dict:
        if self.local_learner is not None:
            return self.local_learner.update(batch)
        import ray_tpu_torch

        n = len(self.actors)
        shard = max(1, len(batch) // n)
        shards = [batch.slice(i * shard, (i + 1) * shard) for i in range(n)]
        metrics = ray_tpu_torch.get(
            [a.update_shard.remote(s) for a, s in zip(self.actors, shards)], timeout=600)
        return metrics[0]

    def get_weights(self):
        if self.local_learner is not None:
            return self.local_learner.get_weights()
        return self._all("get_weights")[0]

    def set_weights(self, params) -> None:
        if self.local_learner is not None:
            self.local_learner.set_weights(params)
        else:
            self._all("set_weights", params)

    def get_state(self) -> dict:
        if self.local_learner is not None:
            return self.local_learner.get_state()
        return self._all("get_state")[0]

    def set_state(self, state: dict) -> None:
        if self.local_learner is not None:
            self.local_learner.set_state(state)
        else:
            self._all("set_state", state)

    def stop(self) -> None:
        import ray_tpu_torch

        for actor in self.actors:
            try:
                ray_tpu_torch.kill(actor)
            except ray_tpu_torch.exceptions.RayTpuError:
                pass  # the learner is already gone


class MultiAgentLearnerGroup:
    """One Learner per module id over a MultiRLModule.

    Role-equivalent of the Learner's MultiRLModule support in the
    reference (rllib/core/learner/learner.py multi-module update): each
    module's update stays its own; weights/state are dicts keyed by module
    id, which is what a multi-agent runner expects from sync_weights.
    """

    def __init__(
        self,
        learner_cls,
        multi_spec,  # MultiRLModuleSpec
        observation_spaces: dict,
        action_spaces: dict,
        config: dict,
        device=None,
    ):
        multi_module = multi_spec.build(observation_spaces, action_spaces, device=device)
        self.learners: dict[str, Learner] = {
            mid: learner_cls(module, config, seed=i, device=device)
            for i, (mid, module) in enumerate(sorted(multi_module.items()))
        }

    @property
    def module_ids(self):
        return self.learners.keys()

    def update(self, batch) -> dict:
        """``batch``: MultiAgentBatch → {module_id: metrics}."""
        return {
            mid: self.learners[mid].update(sub)
            for mid, sub in batch.items()
            if len(sub)
        }

    def update_module(self, module_id: str, batch: SampleBatch) -> dict:
        return self.learners[module_id].update(batch)

    def get_weights(self) -> dict:
        return {mid: l.get_weights() for mid, l in self.learners.items()}

    def set_weights(self, params: dict) -> None:
        for mid, p in params.items():
            self.learners[mid].set_weights(p)

    def get_state(self) -> dict:
        return {mid: l.get_state() for mid, l in self.learners.items()}

    def set_state(self, state: dict) -> None:
        for mid, s in state.items():
            self.learners[mid].set_state(s)

    def stop(self) -> None:
        pass
