"""The port's IMPALA and APPO (``ray_tpu_torch/rllib/algorithms/impala``,
``appo``) against the JAX package's, f32 on the CPU, and the asynchronous
sampling pipeline of ``EnvRunnerGroup``.

* ``vtrace`` (f32 numpy on the host) against the reference's ``lax.scan``
  on seeded sequences of T = 1, 7 and 200 with dones inside and ratios
  above and below both clips, within 1e-6 (max |port - JAX| over
  max(1, max |JAX|)); the reference's own two checks
  (``tests/test_rllib.py:90-128``).
* The stream seam: a runner's env-major fragment is one sequence to both
  packages, so the first stream's last row takes the second stream's first
  value where per-stream V-trace would take its own bootstrap.
* IMPALA's and APPO's loss and gradients on the CartPole MLP and the conv
  net at the f32 bounds (loss 2e-5, gradients 2e-4), APPO with a target
  network apart from the learner's parameters.
* APPO over 5 updates: the adaptive KL coefficient and the target syncs
  equal the reference's.
* ``sample_async`` / ``collect_ready`` interleaved with ``sync_weights``:
  the samples in flight are drained, not read as the fan-out's replies.
* IMPALA and APPO learn CartPole to 80 at the reference's configurations
  and iteration budgets (``tests/test_rllib.py:270-297``,
  ``tests/test_rllib_extras.py:226-250``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl import (  # noqa: F401 (one_torch_thread is an autouse fixture)
    CARTPOLE, F32_TOL, PARAM_TOL, PIXELS, err, one_torch_thread, port_grads, to_port, to_ref,
    tree_err,
)
from ray_tpu.rllib.algorithms.appo import appo as jappo
from ray_tpu.rllib.algorithms.impala import impala as jimpala
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu.rllib.policy import sample_batch as jsb
from ray_tpu_torch.rllib.algorithms.appo import appo as pappo
from ray_tpu_torch.rllib.algorithms.impala import impala as pimpala
from ray_tpu_torch.rllib.core import rl_module as prl
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTION_LOGP, ACTIONS, EPS_ID, OBS, REWARDS, SampleBatch, TERMINATEDS, TRUNCATEDS,
)

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

VTRACE_TOL = 1e-6
MODELS = {
    "mlp": (CARTPOLE, {"fcnet_hiddens": (16, 16)}),
    "conv": (PIXELS, {"post_fcnet_hiddens": (32,)}),
}


# -- vtrace ------------------------------------------------------------------
def _sequence(T, seed):
    rng = np.random.default_rng(seed)
    behaviour = np.log(rng.uniform(0.05, 0.95, T)).astype(np.float32)
    # log-ratios spread over [-2, 2]: rho from 0.14 to 7.4, both sides of
    # the clips at 1.0 (rho) and 0.8 (c)
    target = (behaviour + rng.uniform(-2, 2, T)).astype(np.float32)
    dones = rng.random(T) < 0.15
    return dict(
        behaviour_logp=behaviour, target_logp=target,
        rewards=rng.standard_normal(T).astype(np.float32),
        values=(3 * rng.standard_normal(T)).astype(np.float32),
        bootstrap_value=np.float32(rng.standard_normal()),
        discounts=(0.99 * (1.0 - dones)).astype(np.float32),
    )


@pytest.mark.parametrize("T", [1, 7, 200])
@pytest.mark.parametrize("clips", [(1.0, 1.0), (1.0, 0.8), (2.0, 0.5)])
def test_vtrace_matches_jax(T, clips):
    seq = _sequence(T, seed=T)
    ref = jimpala.vtrace(*(jnp.asarray(seq[k]) for k in seq), *clips)
    got = pimpala.vtrace(*seq.values(), *clips)
    rhos = np.exp(seq["target_logp"] - seq["behaviour_logp"])
    if T == 200:
        assert (rhos > clips[0]).any() and (rhos < clips[1]).any()
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == (T,)
        assert err(g, r) < VTRACE_TOL


def test_vtrace_on_policy_reduces_to_returns():
    """tests/test_rllib.py:90-104: target == behaviour and V = 0 give the
    discounted returns."""
    T = 5
    vs, _ = pimpala.vtrace(np.zeros(T), np.zeros(T), np.ones(T), np.zeros(T), 0.0,
                           np.full(T, 0.9))
    expected = np.array([sum(0.9**k for k in range(T - t)) for t in range(T)])
    np.testing.assert_allclose(vs, expected, rtol=1e-5)


def test_vtrace_clips_off_policy_ratio():
    """tests/test_rllib.py:107-128: a wildly off-policy ratio clips to 1."""
    T = 3
    args = (np.ones(T), np.zeros(T), 0.0, np.full(T, 0.9))
    clipped, _ = pimpala.vtrace(np.zeros(T), np.full(T, 10.0), *args)
    on_policy, _ = pimpala.vtrace(np.zeros(T), np.zeros(T), *args)
    np.testing.assert_allclose(clipped, on_policy, rtol=1e-5)


def test_stream_seam_follows_the_reference():
    """Two envs' streams of 6 steps, flattened env-major as the runner
    lays them out, no done at the seam: both packages run one V-trace over
    the 12 rows, so the first stream's targets take the second stream's
    values. Against per-stream V-trace bootstrapped with the second
    stream's first value V_6, the first stream's vs differ by the second
    stream's correction vs_6 - V_6 carried back through the discounted,
    clipped c_t, and its last row's advantage bootstraps from vs_6."""
    seq = _sequence(12, seed=3)
    seq["discounts"] = np.full(12, 0.99, np.float32)  # no done anywhere
    ref_vs, ref_pg = jimpala.vtrace(*(jnp.asarray(seq[k]) for k in seq))
    vs, pg = pimpala.vtrace(*seq.values())
    assert err(vs, ref_vs) < VTRACE_TOL and err(pg, ref_pg) < VTRACE_TOL
    first = {k: (v[:6] if np.ndim(v) else v) for k, v in seq.items()}
    own_vs, own_pg = pimpala.vtrace(**{**first, "bootstrap_value": seq["values"][6]})
    rhos = np.exp(seq["target_logp"] - seq["behaviour_logp"])
    decay = 0.99 * np.minimum(1.0, rhos[:6])
    carried = np.cumprod(decay[::-1])[::-1] * (vs[6] - seq["values"][6])
    np.testing.assert_allclose(vs[:6], own_vs + carried, rtol=1e-5, atol=1e-5)
    assert abs(carried[5]) > 0.1  # the seam moves the first stream's targets
    clipped = min(1.0, rhos[5])
    np.testing.assert_allclose(
        pg[5], clipped * (seq["rewards"][5] + 0.99 * vs[6] - seq["values"][5]), rtol=1e-5)
    np.testing.assert_allclose(pg[:5], own_pg[:5] + np.minimum(1.0, rhos[:5]) * 0.99
                               * carried[1:], rtol=1e-5, atol=1e-5)


# -- losses and gradients -------------------------------------------------------
def _batch(name, rows, seed) -> dict:
    (obs_space, act_space), _ = MODELS[name]
    rng = np.random.default_rng(seed)
    if obs_space.dtype == np.uint8:
        obs = rng.integers(0, 256, (rows, *obs_space.shape), dtype=np.uint8)
    else:
        obs = rng.standard_normal((rows, *obs_space.shape)).astype(np.float32)
    return {
        OBS: obs,
        ACTIONS: rng.integers(0, act_space.n, rows),
        ACTION_LOGP: np.log(rng.uniform(0.2, 0.8, rows)).astype(np.float32),
        REWARDS: rng.standard_normal(rows).astype(np.float32),
        TERMINATEDS: rng.random(rows) < 0.1,
        TRUNCATEDS: rng.random(rows) < 0.05,
        "bootstrap_value": np.full(rows, rng.standard_normal(), np.float32),
    }


CONFIGS = {
    "impala": (jimpala.IMPALALearner, pimpala.IMPALALearner,
               {"vf_loss_coeff": 0.5, "entropy_coeff": 0.01, "clip_rho_threshold": 1.0,
                "clip_c_threshold": 0.9}),
    "appo": (jappo.APPOLearner, pappo.APPOLearner,
             {"vf_loss_coeff": 0.5, "entropy_coeff": 0.01, "clip_param": 0.3, "kl_coeff": 0.3,
              "kl_target": 0.01, "target_network_update_freq": 3}),
}


def _learners(algo, name, config):
    jcls, pcls, base = CONFIGS[algo]
    (obs_space, act_space), model = MODELS[name]
    config = {**base, **config}
    jl = jcls(jrl.RLModuleSpec(model_config=model).build(obs_space, act_space), config)
    pl = pcls(prl.RLModuleSpec(model_config=model).build(obs_space, act_space, device="cpu"),
              config, device="cpu")
    pl.set_weights(to_port(jl.params))
    if algo == "appo":
        # A target network apart from the parameters: the KL term is live.
        jl.target_params = jl.module.init_params(jax.random.PRNGKey(7))
        pl.target_params = to_port(jl.target_params)
    return jl, pl


def _ref_batch(jl, batch) -> dict:
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if isinstance(jl, jappo.APPOLearner):
        jl._inject_target(out)
    return out


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("algo", CONFIGS)
def test_loss_and_gradients_match_jax(algo, name):
    jl, pl = _learners(algo, name, {})
    batch = _batch(name, 40, seed=1)
    jbatch = _ref_batch(jl, batch)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(jl.compute_loss, has_aux=True)(
        jl.params, jbatch)
    with torch.no_grad():
        loss, metrics = pl.compute_loss(pl.params, pl._device_batch(SampleBatch(batch)))
    assert sorted(metrics) == sorted(ref_metrics)
    assert err(loss, ref_loss) < F32_TOL
    for key in ref_metrics:
        assert err(metrics[key], ref_metrics[key]) < F32_TOL, key
    if algo == "appo":
        assert float(metrics["kl"]) > 1e-3  # the target network is apart
    errs = tree_err(port_grads(pl, SampleBatch(batch)), jax.device_get(ref_grads))
    assert max(errs.values()) < PARAM_TOL, errs


def test_appo_kl_schedule_and_target_sync_match_jax():
    """Five updates from the same parameters and batches: each update's
    metrics at the f32 bounds, the KL coefficient after each equal to the
    reference's (it grows 1.5x above 2x target and halves below 0.5x), and
    the target network synced after the third update in both."""
    jl, pl = _learners("appo", "mlp", {"lr": 1e-2, "kl_target": 0.02})
    coeffs = []
    for step in range(5):
        batch = _batch("mlp", 32, seed=20 + step)
        ref = jl.update(jsb.SampleBatch(batch))
        got = pl.update(SampleBatch(batch))
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert abs(got[key] - ref[key]) / max(1.0, abs(ref[key])) < F32_TOL, (step, key)
        # no KL within 10% of a threshold: the schedule's branch is decided
        assert all(abs(ref["kl"] - edge) > 0.1 * edge for edge in (0.01, 0.04)), ref["kl"]
        assert got["kl_coeff"] == ref["kl_coeff"] == jl._kl_coeff == pl._kl_coeff
        assert pl._updates_since_sync == jl._updates_since_sync
        coeffs.append(got["kl_coeff"])
        errs = tree_err(to_ref(pl.target_params), jax.device_get(jl.target_params))
        assert max(errs.values()) < PARAM_TOL, (step, errs)
    assert len(set(coeffs)) > 2 and any(b < a for a, b in zip(coeffs, coeffs[1:]))
    # synced at the third update: the target is the parameters then.
    state = pl.get_state()
    assert state["updates_since_sync"] == 2 and state["kl_coeff"] == coeffs[-1]
    fresh = _learners("appo", "mlp", {})[1]
    fresh.set_state(state)
    assert fresh._kl_coeff == coeffs[-1]
    for a, b in zip(jax.tree_util.tree_leaves(to_ref(fresh.target_params)),
                    jax.tree_util.tree_leaves(to_ref(pl.target_params))):
        np.testing.assert_array_equal(a, b)


# -- the asynchronous pipeline ---------------------------------------------------
def test_async_sampling_interleaved_with_weight_syncs():
    from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup

    spec = prl.RLModuleSpec(model_config={"fcnet_hiddens": (8,)})
    module = spec.build(*CARTPOLE, device="cpu")
    weights = [module.init_params(seed) for seed in (0, 1)]
    group = EnvRunnerGroup("CartPole-v1", spec, num_env_runners=2, num_envs_per_runner=2,
                           rollout_fragment_length=16, seed=0)
    try:
        group.sync_weights(weights[0])
        group.sample_async()  # both runners sample with weights[0]
        group.sync_weights(weights[1])  # drains them first
        for held in group._all("get_weights"):
            for a, b in zip(jax.tree_util.tree_leaves(to_ref(held)),
                            jax.tree_util.tree_leaves(to_ref(weights[1]))):
                np.testing.assert_array_equal(a, b)
        drained = group.collect_ready(timeout=0.0)
        assert len(drained) == 2 and all(isinstance(b, SampleBatch) for b in drained)
        assert sorted(int(b[EPS_ID][0]) // 10_000_000 for b in drained) == [0, 1]
        assert all(len(b) == 32 for b in drained)
        fresh = []
        while len(fresh) < 2:
            fresh += group.collect_ready(timeout=30.0)
        assert all(isinstance(b, SampleBatch) and len(b) == 32 for b in fresh)
        metrics = group.get_metrics()  # a fan-out with samples in flight
        assert metrics["num_episodes"] >= 0
        assert len(group.collect_ready(timeout=0.0)) == 2  # kept, not lost
    finally:
        group.stop()


# -- learning at the reference's bars ---------------------------------------------
@pytest.mark.parametrize("algo", ["IMPALA", "APPO"])
def test_cartpole_learns_to_80(algo):
    from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig

    config_cls = {"IMPALA": IMPALAConfig, "APPO": APPOConfig}[algo]
    built = (
        config_cls()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=64)
        .training(lr=1e-3, entropy_coeff=0.01, model={"fcnet_hiddens": (64, 64)})
        .debugging(seed=0)
        .build_algo(device="cpu")
    )
    try:
        best = -np.inf
        for _ in range(60):
            result = built.train()
            ret = result.get("episode_return_mean", np.nan)
            if not np.isnan(ret):
                best = max(best, ret)
            if best >= 80.0:
                break
        assert best >= 80.0, f"{algo} failed to learn: best={best}"
    finally:
        built.stop()
