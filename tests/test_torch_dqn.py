"""The port's DQN (``ray_tpu_torch/rllib/algorithms/dqn/dqn.py``) and replay
buffers (``rllib/utils/replay_buffers.py``) against the JAX package's, on
the CPU.

* The TD loss, its metrics and the per-sample |TD| the prioritized buffer
  takes, with double-Q on and off and with PER weights, and the loss's
  gradient, at the f32 bounds (loss 2e-5, gradients and parameters 2e-4),
  from a target network apart from the learner's parameters; then one
  update of each, and ``sync_target``.
* Both replay buffers sample the reference's indexes, rows and weights bit
  for bit from one seed, across the ring's wrap and priority updates.
* DQN learns CartPole to 60 at the reference's configuration and budget
  (``tests/test_rllib.py:300-332``), and the runners' epsilon follows the
  schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl import (  # noqa: F401 (one_torch_thread is an autouse fixture)
    CARTPOLE, F32_TOL, PARAM_TOL, err, one_torch_thread, port_grads, to_port, to_ref,
    tree_err,
)
from ray_tpu.rllib.algorithms.dqn import dqn as jdqn
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu.rllib.policy import sample_batch as jsb
from ray_tpu.rllib.utils import replay_buffers as jrb
from ray_tpu_torch.rllib.algorithms.dqn import dqn as pdqn
from ray_tpu_torch.rllib.core import rl_module as prl
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS, NEXT_OBS, OBS, REWARDS, SampleBatch, TERMINATEDS,
)
from ray_tpu_torch.rllib.utils import replay_buffers as prb

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

MODEL = {"fcnet_hiddens": (16, 16)}


def _learners(double_q: bool):
    config = {"lr": 1e-3, "gamma": 0.97, "double_q": double_q}
    jl = jdqn.DQNLearner(jrl.RLModuleSpec(model_config=MODEL).build(*CARTPOLE), config)
    pl = pdqn.DQNLearner(prl.RLModuleSpec(model_config=MODEL).build(*CARTPOLE, device="cpu"),
                         config, device="cpu")
    pl.set_weights(to_port(jl.params))
    # A target network apart from the parameters, so double-Q's argmax and
    # the target's values come from different nets.
    jl.target_params = jl.module.init_params(jax.random.PRNGKey(5))
    pl.target_params = to_port(jl.target_params)
    return jl, pl


def _batch(rows, seed, weights: bool) -> dict:
    rng = np.random.default_rng(seed)
    batch = {
        OBS: rng.standard_normal((rows, 4)).astype(np.float32),
        NEXT_OBS: rng.standard_normal((rows, 4)).astype(np.float32),
        ACTIONS: rng.integers(0, 2, rows),
        REWARDS: rng.standard_normal(rows).astype(np.float32),
        TERMINATEDS: rng.random(rows) < 0.2,
        "batch_indexes": rng.integers(0, 1000, rows),
    }
    if weights:
        batch["weights"] = rng.uniform(0.1, 1.0, rows).astype(np.float32)
    return batch


@pytest.mark.parametrize("weights", [False, True], ids=["uniform", "per_weights"])
@pytest.mark.parametrize("double_q", [True, False], ids=["double_q", "single_q"])
def test_td_loss_matches_jax(double_q, weights):
    jl, pl = _learners(double_q)
    batch = _batch(48, seed=2, weights=weights)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "batch_indexes"}
    jbatch["target_params"] = jl.target_params
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(jl.compute_loss, has_aux=True)(
        jl.params, jbatch)
    with torch.no_grad():
        loss, metrics = pl.compute_loss(pl.params, pl._device_batch(SampleBatch(batch)))
    assert sorted(metrics) == sorted(ref_metrics) == ["td_abs", "td_error_mean"]
    assert err(loss, ref_loss) < F32_TOL
    assert err(metrics["td_error_mean"], ref_metrics["td_error_mean"]) < F32_TOL
    assert metrics["td_abs"].shape == (48,)
    assert err(metrics["td_abs"], ref_metrics["td_abs"]) < F32_TOL
    errs = tree_err(port_grads(pl, SampleBatch(batch)), jax.device_get(ref_grads))
    assert max(errs.values()) < PARAM_TOL, errs
    # double-Q picks other next actions than the target net's argmax here
    online = np.asarray(jl.module.forward_train(jl.params, jbatch[NEXT_OBS])["logits"])
    target = np.asarray(jl.module.forward_train(jl.target_params, jbatch[NEXT_OBS])["logits"])
    assert (online.argmax(-1) != target.argmax(-1)).any()

    ref = jl.update(jsb.SampleBatch(batch))
    got = pl.update(SampleBatch(batch))
    assert sorted(got) == sorted(ref)
    assert isinstance(got["td_abs"], np.ndarray) and got["td_abs"].shape == (48,)
    assert err(got["td_abs"], ref["td_abs"]) < F32_TOL
    for key in ("total_loss", "td_error_mean"):
        assert abs(got[key] - ref[key]) / max(1.0, abs(ref[key])) < F32_TOL, key
    errs = tree_err(to_ref(pl.get_weights()), jax.device_get(jl.params))
    assert max(errs.values()) < PARAM_TOL, errs
    pl.sync_target()
    for a, b in zip(jax.tree_util.tree_leaves(to_ref(pl.target_params)),
                    jax.tree_util.tree_leaves(to_ref(pl.get_weights()))):
        np.testing.assert_array_equal(a, b)


# -- replay buffers -------------------------------------------------------------
def _rows(n, seed) -> dict:
    rng = np.random.default_rng(seed)
    return {OBS: rng.standard_normal((n, 4)).astype(np.float32),
            ACTIONS: rng.integers(0, 2, n), REWARDS: rng.standard_normal(n).astype(np.float32),
            TERMINATEDS: rng.random(n) < 0.1}


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize("kind", ["uniform", "prioritized"])
def test_replay_buffers_sample_the_reference_rows(kind):
    make = {"uniform": (jrb.ReplayBuffer, prb.ReplayBuffer),
            "prioritized": (jrb.PrioritizedReplayBuffer, prb.PrioritizedReplayBuffer)}[kind]
    ref, port = (cls(capacity=50, seed=11) for cls in make)
    rng = np.random.default_rng(3)
    for step in range(6):  # 6 x 13 rows: the ring wraps
        rows = _rows(13, seed=step)
        ref.add(jsb.SampleBatch(rows))
        port.add(SampleBatch(rows))
        assert len(port) == len(ref) == min(50, 13 * (step + 1))
        for _ in range(2):
            got, want = port.sample(16), ref.sample(16)
            _assert_same(got, want)
            if kind == "prioritized":
                assert "weights" in got
                td = rng.standard_normal(16).astype(np.float32) * 3
                ref.update_priorities(want["batch_indexes"], td)
                port.update_priorities(got["batch_indexes"], td)
                np.testing.assert_array_equal(port._priorities, ref._priorities)
                assert port._max_priority == ref._max_priority


def test_replay_ring_keeps_the_last_items():
    """tests/test_rllib.py:133-142."""
    buf = prb.ReplayBuffer(capacity=10, seed=0)
    buf.add(SampleBatch({OBS: np.arange(25).reshape(25, 1)}))
    assert len(buf) == 10
    sample = buf.sample(4)
    assert len(sample) == 4 and sample[OBS].min() >= 15


# -- learning at the reference's bar ----------------------------------------------
def test_dqn_cartpole_learns_to_60():
    from ray_tpu_torch.rllib import DQNConfig

    algo = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=8, rollout_fragment_length=32)
        .training(
            lr=1e-3,
            train_batch_size=64,
            num_steps_sampled_before_learning_starts=500,
            target_network_update_freq=500,
            epsilon_timesteps=3000,
            updates_per_iteration=64,
            model={"fcnet_hiddens": (64, 64)},
        )
        .debugging(seed=0)
        .build_algo(device="cpu")
    )
    try:
        best, epsilons = -np.inf, []
        for _ in range(50):
            result = algo.train()
            epsilons.append(result["learner/epsilon"])
            ret = result.get("episode_return_mean", np.nan)
            if not np.isnan(ret):
                best = max(best, ret)
            if best >= 60.0:
                break
        assert best >= 60.0, f"DQN failed to learn: best={best}"
        # epsilon falls linearly from 1.0 by 256 env steps an iteration
        np.testing.assert_allclose(epsilons[:3], [1.0, 1 - 0.95 * 256 / 3000,
                                                  1 - 0.95 * 512 / 3000])
    finally:
        algo.stop()
