"""The port's SAC and CQL (``ray_tpu_torch/rllib/algorithms/sac``, ``cql``)
against the JAX package's, f32 on the CPU.

JAX's PRNG cannot be reproduced in torch, so the port's step takes its
noise as tensors; these tests draw that noise from the reference's own key
by the reference's splits (``SACLearner.update`` splits the learner's key,
the step splits it into actor / next / reg at ``sac.py:151``, CQL splits
reg into rand / pi at ``cql.py:69`` and vmaps the sampling over
``split(rng_pi, n)`` at ``cql.py:80``) and hand it to the port.

* ``SACModule.sample_action`` with the key's normals, and the greedy
  action, within 2e-5, inside the action box.
* Three ``SACLearner`` and three ``CQLLearner`` steps: every metric, every
  parameter and both target towers against the reference's jitted step
  with the same keys, at the f32 bounds (metrics 2e-5, parameters 2e-4);
  ``initial_alpha`` and ``target_entropy`` as configured.
* Where gradients stop: the actor's loss reaches ``pi`` and not the
  critics, the critic's loss not ``pi``, and ``alpha`` takes a gradient
  only from the temperature loss.
* SAC learns Pendulum (greedy evaluation at -750) at the reference's
  configuration and budget (``tests/test_rllib_extras.py:504-539``).
* Two runs from one seed give equal learner metrics and evaluations.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl import (  # noqa: F401 (one_torch_thread is an autouse fixture)
    F32_TOL, PARAM_TOL, PENDULUM, err, one_torch_thread, to_port, to_ref, tree_err,
)
from ray_tpu.rllib.algorithms.cql import cql as jcql
from ray_tpu.rllib.algorithms.sac import sac as jsac
from ray_tpu.rllib.policy import sample_batch as jsb
from ray_tpu_torch.rllib.algorithms.cql import cql as pcql
from ray_tpu_torch.rllib.algorithms.sac import sac as psac
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS, NEXT_OBS, OBS, REWARDS, SampleBatch, TERMINATEDS,
)

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

MODEL = {"fcnet_hiddens": (16, 16)}
BOX2 = (PENDULUM[0], gym.spaces.Box(-1.0, 3.0, (2,), np.float32))


def _modules(spaces=PENDULUM):
    return (jsac.SACModule(*spaces, MODEL), psac.SACModule(*spaces, MODEL, device="cpu"))


# ulps of tanh's result the two libraries' tanh may differ by
TANH_ULPS = 4


@pytest.mark.parametrize("obs_scale", [1.0, 3.0], ids=["unsaturated", "saturated"])
@pytest.mark.parametrize("spaces", [PENDULUM, BOX2], ids=["pendulum", "box2"])
def test_sample_action_matches_jax(spaces, obs_scale):
    """Actions within 2e-5 and inside the box; logp within 2e-5 where the
    squash is well conditioned. Where tanh saturates (1 - a^2 < 1e-3, the
    observations scaled by 3) the squash term log(1 - a^2 + 1e-6) turns
    tanh's last-place rounding, which differs between XLA's and torch's
    tanh, into an error of 2|a| ulp(a) / (1 - a^2 + 1e-6) a dimension:
    those rows are held to that, for TANH_ULPS ulps."""
    jmod, pmod = _modules(spaces)
    params = jmod.init_params(jax.random.PRNGKey(0))
    port = to_port(params)
    obs = np.random.default_rng(1).standard_normal((64, 3)).astype(np.float32) * obs_scale
    key = jax.random.PRNGKey(2)
    ref_a, ref_logp = jmod.sample_action(params["pi"], jnp.asarray(obs), key)
    noise = np.array(jax.random.normal(key, (64, pmod.act_dim)))
    a, logp = pmod.sample_action(port["pi"], torch.from_numpy(obs), torch.from_numpy(noise))
    assert err(a, ref_a) < F32_TOL
    low, high = spaces[1].low, spaces[1].high
    assert np.all(a.numpy() >= low) and np.all(a.numpy() <= high)
    squashed = (np.asarray(ref_a) - (high + low) / 2) / ((high - low) / 2)  # tanh(u)
    room = 1 - squashed.astype(np.float64) ** 2
    slack = (2 * np.abs(squashed) * TANH_ULPS * np.spacing(np.float32(1)) / 2
             / (room + 1e-6)).sum(-1)
    saturated = (room < 1e-3).any(-1)
    assert saturated.any() or obs_scale == 1  # the scaled case reaches saturation
    diff = np.abs(logp.numpy() - np.asarray(ref_logp, np.float64))
    scale = max(1.0, float(np.abs(ref_logp).max()))
    assert diff[~saturated].max() / scale < F32_TOL
    assert np.all(diff <= F32_TOL * scale + slack)
    greedy = pmod.forward_inference(port, torch.from_numpy(obs))
    assert err(greedy, jmod.forward_inference(params, obs)) < F32_TOL
    assert np.all(greedy.numpy() >= low) and np.all(greedy.numpy() <= high)
    actions, logp, extra = pmod.forward_exploration(port, torch.from_numpy(obs),
                                                    torch.Generator().manual_seed(0))
    assert actions.shape == (64, pmod.act_dim) and torch.isfinite(logp).all()
    assert (extra["vf_preds"] == 0).all()


def _batch(rows, seed) -> dict:
    rng = np.random.default_rng(seed)
    return {
        OBS: rng.standard_normal((rows, 3)).astype(np.float32),
        ACTIONS: rng.uniform(-2, 2, (rows, 1)).astype(np.float32),
        REWARDS: rng.standard_normal(rows).astype(np.float32),
        NEXT_OBS: rng.standard_normal((rows, 3)).astype(np.float32),
        TERMINATEDS: rng.random(rows) < 0.1,
    }


def _noise(jl, rows: int, act_dim: int, cql_n: int | None) -> dict:
    """The normals (and CQL's uniforms) the reference's next update draws,
    from its learner's key by its own splits."""
    _, key = jax.random.split(jl._rng)
    rng_actor, rng_next, rng_reg = jax.random.split(key, 3)
    shape = (rows, act_dim)
    noise = {"actor": jax.random.normal(rng_actor, shape),
             "next": jax.random.normal(rng_next, shape)}
    if cql_n:
        rng_rand, rng_pi = jax.random.split(rng_reg)
        noise["rand_u"] = jax.random.uniform(rng_rand, (cql_n, *shape), minval=-1.0, maxval=1.0)
        noise["pi"] = jnp.stack([jax.random.normal(k, shape)
                                 for k in jax.random.split(rng_pi, cql_n)])
    return {k: np.asarray(v) for k, v in noise.items()}


LEARNERS = {
    "sac": (jsac.SACLearner, psac.SACLearner, {}),
    "cql": (jcql.CQLLearner, pcql.CQLLearner, {"cql_alpha": 2.0, "cql_n_actions": 4}),
}


def _learners(kind, config):
    jcls, pcls, extra = LEARNERS[kind]
    jmod, pmod = _modules()
    config = {"lr": 3e-3, "tau": 0.05, "gamma": 0.97, **extra, **config}
    jl, pl = jcls(jmod, config), pcls(pmod, config, device="cpu")
    pl.set_weights(to_port(jl.params))
    pl.target_params = to_port(jl.target_params)
    return jl, pl


@pytest.mark.parametrize("config", [
    {}, {"initial_alpha": 0.5, "target_entropy": -2.0, "grad_clip": 1.0},
], ids=["defaults", "alpha_entropy_clip"])
@pytest.mark.parametrize("kind", LEARNERS)
def test_three_steps_match_jax(kind, config):
    jl, pl = _learners(kind, config)
    if "initial_alpha" in config:
        assert pl.params["log_alpha"].item() == float(jl.params["log_alpha"]) == np.float32(
            np.log(0.5))
    n = LEARNERS[kind][2].get("cql_n_actions")
    for step in range(3):
        batch = _batch(32, seed=40 + step)
        noise = _noise(jl, 32, pl.module.act_dim, n)
        ref = jl.update(jsb.SampleBatch(batch))
        got = pl.update(SampleBatch(batch), noise=noise)
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert abs(got[key] - ref[key]) / max(1.0, abs(ref[key])) < F32_TOL, (step, key)
        errs = tree_err(to_ref(pl.get_weights()), jax.device_get(jl.params))
        assert max(errs.values()) < PARAM_TOL, (step, errs)
        errs = tree_err(to_ref(pl.target_params), jax.device_get(jl.target_params))
        assert max(errs.values()) < PARAM_TOL, (step, errs)
    if kind == "cql":
        assert "cql_penalty" in got and "cql_gap" in got
    # the state round trip carries the targets
    state = pl.get_state()
    fresh = _learners(kind, config)[1]
    fresh.set_state(state)
    for a, b in zip(jax.tree_util.tree_leaves(to_ref(fresh.target_params)),
                    jax.tree_util.tree_leaves(to_ref(pl.target_params))):
        np.testing.assert_array_equal(a, b)


def test_gradients_stop_where_the_reference_stops_them():
    """The port's total loss differentiated term by term: the actor's loss
    reaches pi only, the critic's loss q1 and q2 only, the temperature's
    log_alpha only (sac.py:160-195)."""
    _, pl = _learners("sac", {})
    batch = pl._to_device(SampleBatch(_batch(16, seed=3)))
    noise = pl.draw_noise(16)
    _, metrics = pl.sac_loss(pl.params, batch, noise)
    leaves = {k: [t for t in _flat(pl.params[k])] for k in pl.params}

    def reached(loss):
        grads = torch.autograd.grad(loss, [t for k in leaves for t in leaves[k]],
                                    retain_graph=True, allow_unused=True)
        out, i = {}, 0
        for k in leaves:
            gs = grads[i:i + len(leaves[k])]
            i += len(leaves[k])
            out[k] = any(g is not None and bool(g.abs().sum() > 0) for g in gs)
        return out

    assert reached(metrics["actor_loss"]) == {"pi": True, "q1": False, "q2": False,
                                              "log_alpha": False}
    assert reached(metrics["critic_loss"]) == {"pi": False, "q1": True, "q2": True,
                                               "log_alpha": False}
    assert reached(metrics["alpha_loss"]) == {"pi": False, "q1": False, "q2": False,
                                              "log_alpha": True}


def _flat(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def test_sac_trees_convert_both_ways():
    """models/convert.py carries SAC's tree (a 0-d log_alpha) and the target
    towers across, matched by key path; the port's own init has the
    reference's paths and shapes."""
    jmod, pmod = _modules()
    jl = jsac.SACLearner(jmod, {})

    def paths(tree):
        return [(jax.tree_util.keystr(p), np.shape(x))
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]

    for tree in (jl.params, jl.target_params):
        ref = jax.device_get(tree)
        back = to_ref(to_port(ref))
        assert paths(back) == paths(ref)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)
    own = to_ref(pmod.init_params(0))
    assert paths(own) == paths(jax.device_get(jl.params)) and own["log_alpha"].shape == ()


def test_sac_learner_defaults_draw_their_own_noise():
    """tests/test_rllib_extras.py:468-501: tau 0.5 moves the targets; the
    learner's generator draws the step's noise."""
    jmod, pmod = _modules()
    learner = psac.SACLearner(pmod, {"lr": 3e-4, "tau": 0.5}, device="cpu")
    before = to_ref(learner.target_params)
    metrics = learner.update(SampleBatch(_batch(32, seed=0)))
    assert np.isfinite(metrics["total_loss"]) and metrics["alpha"] > 0
    after = to_ref(learner.target_params)
    assert any(not np.allclose(a, b) for a, b in zip(jax.tree_util.tree_leaves(before),
                                                      jax.tree_util.tree_leaves(after)))
    assert learner._target_entropy == -1.0


def test_sac_pendulum_learns():
    from ray_tpu_torch.rllib import SACConfig

    algo = (
        SACConfig()
        .environment("Pendulum-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=8, rollout_fragment_length=25)
        .training(lr=3e-4, train_batch_size=256, num_steps_sampled_before_learning_starts=1000,
                  updates_per_iteration=200, model={"fcnet_hiddens": (64, 64)})
        .debugging(seed=0)
        .build_algo(device="cpu")
    )
    try:
        best = -np.inf
        for i in range(60):
            algo.train()
            # greedy evaluation, as the reference thresholds it
            if i >= 14 and (i - 14) % 5 == 0:
                best = max(best, algo.evaluate()["episode_return_mean"])
                if best >= -750.0:
                    break
        assert best >= -750.0, f"SAC failed to learn Pendulum: best={best}"
    finally:
        algo.stop()


def _sac_run(iterations: int) -> list:
    from ray_tpu_torch.rllib import SACConfig

    algo = (
        SACConfig()
        .environment("Pendulum-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=8, rollout_fragment_length=25)
        .training(lr=3e-4, train_batch_size=256, num_steps_sampled_before_learning_starts=200,
                  updates_per_iteration=20, model={"fcnet_hiddens": (64, 64)})
        .debugging(seed=0)
        .build_algo(device="cpu")
    )
    try:
        out = [{k: v for k, v in algo.train().items() if k.startswith("learner/")}
               for _ in range(iterations)]
        return out + [algo.evaluate()]
    finally:
        algo.stop()


def test_sac_runs_from_one_seed_are_equal():
    """Three iterations (learning from the first) and a greedy evaluation,
    twice from seed 0: every learner metric and the evaluation's return are
    equal, bit for bit."""
    first, second = _sac_run(3), _sac_run(3)
    assert len(first[0]) > 5 and "learner/critic_loss" in first[0]
    assert first == second
