"""The port's PPO learner (``ray_tpu_torch/rllib/algorithms/ppo/ppo.py``,
``rllib/core/learner.py``) against the JAX package's, f32 on the CPU.

* The PPO loss and its metrics on a fixed batch.
* A 3-minibatch learner trajectory against the reference's ``Learner``
  (``optax.chain(clip_by_global_norm, adam)``): the metrics of every
  update, the parameters after each, Adam's moments and count at the end;
  once with ``grad_clip`` small enough that the clip branch fires.
* The GAE copy against ``ray_tpu.rllib.utils.postprocessing.compute_gae``
  on the reference's own cases (``tests/test_rllib.py:41-88``) and on a
  batch of several episodes, truncations and cut fragments.
* One ``training_step`` (GAE with its bootstrap calls on the learner,
  ``num_epochs`` of minibatches in ``default_rng(iteration)`` order, the
  weight sync) on fixed fragments, MLP and LSTM, against the reference's
  parameters afterwards.
* A 2-rank gloo ``num_learners=2`` update against one learner on the whole
  batch.
* ``MultiAgentLearnerGroup`` (one learner a module id) over a
  ``MultiRLModuleSpec``: one update of each module against the reference's.

Parameters start from the JAX init and go through
``convert.rl_params_from_numpy``. Bounds as ROADMAP's parity rules set them
for f32: losses 2e-5, parameters after updates 2e-4, as max |port - JAX|
over max(1, max |JAX|).
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib.algorithms.ppo import ppo as jppo
from ray_tpu.rllib.core import learner as jlearner
from ray_tpu.rllib.core import multi_rl_module as jmrm
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu.rllib.policy import sample_batch as jsb
from ray_tpu.rllib.utils import postprocessing as jpost
from ray_tpu_torch.models.convert import rl_params_from_numpy, rl_params_to_numpy
from ray_tpu_torch.rllib.algorithms.ppo import ppo as pppo
from ray_tpu_torch.rllib.core import learner as plearner
from ray_tpu_torch.rllib.core import multi_rl_module as pmrm
from ray_tpu_torch.rllib.core import rl_module as prl
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTION_LOGP, ACTIONS, ADVANTAGES, EPS_ID, NEXT_OBS, OBS, REWARDS, MultiAgentBatch,
    SampleBatch, TERMINATEDS, TRUNCATEDS, VALUE_TARGETS, VF_PREDS,
)
from ray_tpu_torch.rllib.utils import postprocessing as ppost

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

F32_TOL = 2e-5
PARAM_TOL = 2e-4
CARTPOLE = (gym.spaces.Box(-1, 1, (4,), np.float32), gym.spaces.Discrete(2))
PIXELS = (gym.spaces.Box(0, 255, (32, 32, 1), np.uint8), gym.spaces.Discrete(2))
MODELS = {
    "mlp": (CARTPOLE, {"fcnet_hiddens": (16, 16)}),
    "conv": (PIXELS, {"post_fcnet_hiddens": (32,)}),
    "lstm": (CARTPOLE, {"use_lstm": True, "fcnet_hiddens": (16,), "lstm_cell_size": 8,
                        "max_seq_len": 8}),
}
PPO_CONFIG = {"clip_param": 0.2, "vf_clip_param": 10.0, "vf_loss_coeff": 0.5,
              "entropy_coeff": 0.01}


def _err(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(port - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def _tree_err(port_tree, ref_tree) -> dict:
    """{path: error} over the leaves of two numpy trees of the reference's layout."""
    port = dict(jax.tree_util.tree_flatten_with_path(port_tree)[0])
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert len(port) == len(ref)
    return {jax.tree_util.keystr(path): _err(port[path], leaf) for path, leaf in ref}


def _port_weights(weights) -> dict:
    """The port's numpy weights (get_weights) in the reference's layout."""
    return rl_params_to_numpy(plearner._tensors(weights, "cpu"))


def _learners(name, config):
    (obs_space, act_space), model = MODELS[name]
    jmod = jrl.RLModuleSpec(model_config=model).build(obs_space, act_space)
    pmod = prl.RLModuleSpec(model_config=model).build(obs_space, act_space, device="cpu")
    jl = jppo.PPOLearner(jmod, config)
    pl = pppo.PPOLearner(pmod, config, device="cpu")
    pl.set_weights(rl_params_from_numpy(jax.device_get(jl.params), device="cpu"))
    return jl, pl


def _batch(name, rows, seed) -> dict:
    (obs_space, act_space), _ = MODELS[name]
    rng = np.random.default_rng(seed)
    if obs_space.dtype == np.uint8:
        obs = rng.integers(0, 256, (rows, *obs_space.shape), dtype=np.uint8)
    else:
        obs = rng.standard_normal((rows, *obs_space.shape)).astype(np.float32)
    dones = rng.random(rows) < 0.1
    return {
        OBS: obs,
        ACTIONS: rng.integers(0, act_space.n, rows),
        ACTION_LOGP: np.log(rng.uniform(0.2, 0.8, rows)).astype(np.float32),
        ADVANTAGES: rng.standard_normal(rows).astype(np.float32),
        VALUE_TARGETS: (3 * rng.standard_normal(rows)).astype(np.float32),
        TERMINATEDS: dones,
        TRUNCATEDS: np.zeros(rows, bool),
    }


@pytest.mark.parametrize("name", MODELS)
def test_ppo_loss_and_metrics_match_jax(name):
    jl, pl = _learners(name, PPO_CONFIG)
    batch = _batch(name, 48, seed=1)
    ref_loss, ref_metrics = jl.compute_loss(jl.params, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
    with torch.no_grad():
        loss, metrics = pl.compute_loss(pl.params, pl._to_device(SampleBatch(batch)))
    assert sorted(metrics) == sorted(ref_metrics) == ["entropy", "kl", "policy_loss", "vf_loss"]
    assert _err(loss, ref_loss) < F32_TOL
    for key in ref_metrics:
        assert _err(metrics[key], ref_metrics[key]) < F32_TOL, key


def _adam_state(opt_state) -> optax.ScaleByAdamState:
    states = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    (adam,) = [s for s in states if isinstance(s, optax.ScaleByAdamState)]
    return adam


def _port_grads(pl, grads) -> dict:
    """The port's gradient list (named_leaves order) as a tree of the
    reference's layout."""
    values = iter(grads)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        return next(values)

    return rl_params_to_numpy(fill(pl.params))


def _in_order_of(params, tree) -> list:
    """tree's leaves in the order ``named_leaves(params)`` takes, matched by key."""
    out = []

    def walk(p, t):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], t[k])
        elif isinstance(p, list):
            for a, b in zip(p, t):
                walk(a, b)
        else:
            out.append(t)

    walk(params, tree)
    return out


@pytest.mark.parametrize("name", ["mlp", "conv"])
@pytest.mark.parametrize("grad_clip", [1000.0, 0.05], ids=["no_clip", "clip_fires"])
def test_three_minibatch_trajectory_matches_optax(name, grad_clip):
    """Each step: the port's gradient against JAX's (2e-4), then one update
    of each learner from the same parameters, after which the metrics hold
    at 2e-5 and every parameter at 2e-4. The CartPole MLP takes the port's
    ``update`` whole. The conv net's step applies JAX's gradient through
    ``apply_gradients`` (the clip and Adam): its first conv weight holds
    components whose gradient (1e-8 against a largest 0.29) is below f32's
    resolution of the sum that makes it, noise in both packages, and Adam's
    first steps move any such component by about lr whatever its size."""
    config = {**PPO_CONFIG, "lr": 3e-3, "grad_clip": grad_clip}
    jl, pl = _learners(name, config)
    for step in range(3):
        batch = _batch(name, 32, seed=10 + step)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        ref_grads = jax.grad(lambda p: jl.compute_loss(p, jbatch)[0])(jl.params)
        # The clip branch fires (or not) on every step, as the case says.
        norm = float(optax.global_norm(ref_grads))
        assert (norm >= grad_clip) == (grad_clip < 1), norm
        grads = pl.compute_gradients(SampleBatch(batch))
        errs = _tree_err(_port_grads(pl, grads), jax.device_get(ref_grads))
        assert max(errs.values()) < PARAM_TOL, (step, errs)
        with torch.no_grad():
            loss, metrics = pl.compute_loss(pl.params, pl._to_device(SampleBatch(batch)))
        ref = jl.update(jsb.SampleBatch(batch))
        metrics = {**{k: float(v) for k, v in metrics.items()}, "total_loss": float(loss)}
        if name == "mlp":
            got = pl.update(SampleBatch(batch))
            assert all(isinstance(v, float) for v in got.values())
            assert got == pytest.approx(metrics, rel=1e-6, abs=1e-6)
        else:
            tree = rl_params_from_numpy(jax.device_get(ref_grads), device="cpu")
            pl.apply_gradients(_in_order_of(pl.params, tree))
        assert sorted(metrics) == sorted(ref)
        for key in ref:
            assert abs(metrics[key] - ref[key]) / max(1.0, abs(ref[key])) < F32_TOL, (step, key)
        errs = _tree_err(_port_weights(pl.get_weights()), jax.device_get(jl.params))
        assert max(errs.values()) < PARAM_TOL, (step, errs)
    adam = _adam_state(jl.opt_state)
    opt = pl.get_state()["opt_state"]
    assert opt["count"] == int(adam.count) == 3
    for port, ref in ((opt["mu"], adam.mu), (opt["nu"], adam.nu)):
        errs = _tree_err(_port_weights(port), jax.device_get(ref))
        # Moments of order g and g^2 (far below 1): held relative to their
        # largest entry.
        for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(ref))[0]:
            scale = float(np.max(np.abs(leaf)))
            assert errs[jax.tree_util.keystr(path)] * max(1.0, scale) <= PARAM_TOL * scale + 1e-12


def test_learner_state_round_trip_is_exact():
    _, pl = _learners("mlp", PPO_CONFIG)
    pl.update(SampleBatch(_batch("mlp", 32, seed=3)))
    state = pl.get_state()
    after = pl.update(SampleBatch(_batch("mlp", 32, seed=4)))
    pl.set_state(state)
    again = pl.update(SampleBatch(_batch("mlp", 32, seed=4)))
    assert after == again
    for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(pl.get_state())):
        assert np.shape(a) == np.shape(b)


# -- GAE ------------------------------------------------------------------
def _gae_cases():
    # tests/test_rllib.py:41-88: a terminal episode, and a cut that bootstraps.
    yield dict(batch={
        REWARDS: np.array([1.0, 1.0, 1.0], np.float32), VF_PREDS: np.zeros(3, np.float32),
        TERMINATEDS: np.array([False, False, True]), TRUNCATEDS: np.zeros(3, bool),
        NEXT_OBS: np.zeros((3, 1)), EPS_ID: np.array([7, 7, 7])},
        kwargs=dict(gamma=0.9, lambda_=1.0, standardize=False))
    yield dict(batch={
        REWARDS: np.array([0.0], np.float32), VF_PREDS: np.array([0.0], np.float32),
        TERMINATEDS: np.array([False]), TRUNCATEDS: np.array([False]),
        NEXT_OBS: np.zeros((1, 1)), EPS_ID: np.array([1])},
        kwargs=dict(gamma=0.5, lambda_=1.0, standardize=False,
                    value_fn=lambda obs: np.array([10.0])))
    # Several episodes: a termination, a truncation and a cut fragment,
    # bootstrapped from a value function of next_obs; standardized.
    rng = np.random.default_rng(0)
    eps = np.repeat([3, 4, 5, 9], [5, 7, 6, 6])
    term = np.zeros(24, bool)
    term[4] = True
    trunc = np.zeros(24, bool)
    trunc[11] = True
    yield dict(batch={
        REWARDS: rng.standard_normal(24).astype(np.float32),
        VF_PREDS: rng.standard_normal(24).astype(np.float32),
        TERMINATEDS: term, TRUNCATEDS: trunc,
        NEXT_OBS: rng.standard_normal((24, 2)).astype(np.float32), EPS_ID: eps},
        kwargs=dict(gamma=0.99, lambda_=0.95,
                    value_fn=lambda obs: np.asarray(obs).sum(-1)))


@pytest.mark.parametrize("case", range(3))
def test_gae_matches_the_reference(case):
    spec = list(_gae_cases())[case]
    ref = jpost.compute_gae(jsb.SampleBatch(spec["batch"]), **spec["kwargs"])
    got = ppost.compute_gae(SampleBatch(spec["batch"]), **spec["kwargs"])
    for key in (ADVANTAGES, VALUE_TARGETS):
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])


# -- training_step on fixed fragments --------------------------------------
class _Fragments:
    """An env runner group that hands out fixed fragments and records the
    weights it is sent."""

    def __init__(self, fragments, batch_cls):
        self._fragments = iter(fragments)
        self._batch_cls = batch_cls
        self.synced = []

    def sample(self):
        return self._batch_cls({k: v.copy() for k, v in next(self._fragments).items()})

    def sync_weights(self, params) -> None:
        self.synced.append(params)


def _fragment(seed, envs=2, steps=32) -> dict:
    """Env-major rows of ``envs`` envs: in each, an episode that terminates
    or truncates, then one cut at the fragment's end."""
    rng = np.random.default_rng(seed)
    rows = envs * steps
    term, trunc = np.zeros(rows, bool), np.zeros(rows, bool)
    eps = np.zeros(rows, np.int64)
    for e in range(envs):
        end = e * steps + int(rng.integers(5, steps - 5))
        (term if e % 2 == 0 else trunc)[end] = True
        eps[e * steps:end + 1] = 100 * seed + 2 * e
        eps[end + 1:(e + 1) * steps] = 100 * seed + 2 * e + 1
    obs = rng.standard_normal((rows, 4)).astype(np.float32)
    return {
        OBS: obs, NEXT_OBS: rng.standard_normal((rows, 4)).astype(np.float32),
        ACTIONS: rng.integers(0, 2, rows), REWARDS: np.ones(rows, np.float32),
        TERMINATEDS: term, TRUNCATEDS: trunc,
        ACTION_LOGP: np.log(rng.uniform(0.3, 0.7, rows)).astype(np.float32),
        VF_PREDS: rng.standard_normal(rows).astype(np.float32), EPS_ID: eps,
    }


def _bare_ppo(cls, config, learner_group, fragments, batch_cls, **attrs):
    """A PPO whose runners are ``fragments`` (no envs, no processes)."""
    algo = cls.__new__(cls)
    algo.config = config
    algo.iteration = 0
    algo._total_env_steps = 0
    algo.observation_space = algo.module_observation_space = CARTPOLE[0]
    algo.action_space = CARTPOLE[1]
    algo.learner_group = learner_group
    algo.env_runner_group = _Fragments(fragments, batch_cls)
    for key, value in attrs.items():
        setattr(algo, key, value)
    return algo


@pytest.mark.parametrize("name", ["mlp", "lstm"])
def test_training_step_matches_jax(name):
    from ray_tpu.rllib.algorithms.ppo.ppo import PPOConfig as JConfig
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig as PConfig

    model = MODELS[name][1]
    fragments = [_fragment(seed) for seed in range(1, 5)]
    algos = []
    for pkg, config_cls in (("jax", JConfig), ("port", PConfig)):
        config = (config_cls().environment("CartPole-v1")
                  .env_runners(rollout_fragment_length=32)
                  .training(lr=1e-3, train_batch_size=256, minibatch_size=64, num_epochs=2,
                            entropy_coeff=0.01, model=model))
        if pkg == "jax":
            algo = _bare_ppo(jppo.PPO, config, None, fragments, jsb.SampleBatch)
            spec = jrl.RLModuleSpec(model_config=dict(config.model))
            algo.learner_group = jlearner.LearnerGroup(
                jppo.PPOLearner, spec, *CARTPOLE, algo._learner_config())
        else:
            algo = _bare_ppo(pppo.PPO, config, None, fragments, SampleBatch,
                             device=torch.device("cpu"))
            spec = prl.RLModuleSpec(model_config=dict(config.model))
            algo.learner_group = plearner.LearnerGroup(
                pppo.PPOLearner, spec, *CARTPOLE, algo._learner_config(), device="cpu")
            algo.learner_group.set_weights(rl_params_from_numpy(
                jax.device_get(algos[0].learner_group.get_weights()), device="cpu"))
        algos.append(algo)
    ref = algos[0].training_step()
    got = algos[1].training_step()
    assert got["num_env_steps_trained"] == ref["num_env_steps_trained"] == 256
    for key in ("total_loss", "policy_loss", "vf_loss", "entropy", "kl"):
        assert abs(got[key] - ref[key]) / max(1.0, abs(ref[key])) < PARAM_TOL, key
    ref_weights = jax.device_get(algos[0].learner_group.get_weights())
    port_weights = algos[1].learner_group.get_weights()
    errs = _tree_err(_port_weights(port_weights), ref_weights)
    assert max(errs.values()) < PARAM_TOL, errs
    # The runners got the learner's weights after the epochs.
    (synced,) = algos[1].env_runner_group.synced
    for a, b in zip(jax.tree_util.tree_leaves(synced), jax.tree_util.tree_leaves(port_weights)):
        np.testing.assert_array_equal(a, b)


def test_value_function_runs_the_value_head():
    _, pl = _learners("mlp", PPO_CONFIG)
    obs = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    vf = pppo.value_function(pl.module, pl.params)(obs)
    with torch.no_grad():
        want = pl.module.forward_train(pl.params, torch.from_numpy(obs))["vf"].numpy()
    assert isinstance(vf, np.ndarray) and vf.shape == (3,)
    np.testing.assert_array_equal(vf, want)


# -- data parallelism across learners --------------------------------------
def test_two_gloo_learners_match_one_on_the_whole_batch():
    spec = prl.RLModuleSpec(model_config=MODELS["mlp"][1])
    config = {**PPO_CONFIG, "lr": 3e-4, "grad_clip": 40.0}
    one = plearner.LearnerGroup(pppo.PPOLearner, spec, *CARTPOLE, config, device="cpu")
    two = plearner.LearnerGroup(pppo.PPOLearner, spec, *CARTPOLE, config, num_learners=2,
                                device="cpu")
    try:
        start = two.get_weights()
        for a, b in zip(jax.tree_util.tree_leaves(start),
                        jax.tree_util.tree_leaves(one.get_weights())):
            np.testing.assert_array_equal(a, b)
        for seed in (20, 21):
            batch = SampleBatch(_batch("mlp", 64, seed=seed))
            one.update(batch)
            metrics = two.update(batch)
            assert np.isnan(metrics["total_loss"])  # the reference's DP report
        errs = _tree_err(two.get_weights(), one.get_weights())
        assert max(errs.values()) < 1e-5, errs
        # Every learner of the gang holds the same parameters.
        ranks = two._all("get_weights")
        for a, b in zip(jax.tree_util.tree_leaves(ranks[0]), jax.tree_util.tree_leaves(ranks[1])):
            np.testing.assert_array_equal(a, b)
        moved = _tree_err(two.get_weights(), start)
        assert min(moved.values()) > 0
    finally:
        two.stop()


# -- multi-agent learner group ----------------------------------------------
def test_multi_agent_learner_group_matches_jax():
    spaces = {"p0": CARTPOLE, "p1": (gym.spaces.Box(-1, 1, (3,), np.float32),
                                     gym.spaces.Discrete(3))}
    models = {"p0": {"fcnet_hiddens": (16,)}, "p1": {"fcnet_hiddens": (8, 8)}}
    obs_spaces = {mid: s[0] for mid, s in spaces.items()}
    act_spaces = {mid: s[1] for mid, s in spaces.items()}
    config = {**PPO_CONFIG, "lr": 1e-3}
    jg = jlearner.MultiAgentLearnerGroup(
        jppo.PPOLearner, jmrm.MultiRLModuleSpec(
            {m: jrl.RLModuleSpec(model_config=c) for m, c in models.items()}),
        obs_spaces, act_spaces, config)
    pspec = pmrm.MultiRLModuleSpec({m: prl.RLModuleSpec(model_config=c)
                                    for m, c in models.items()})
    pg = plearner.MultiAgentLearnerGroup(pppo.PPOLearner, pspec, obs_spaces, act_spaces, config,
                                         device="cpu")
    assert sorted(pg.module_ids) == sorted(jg.module_ids) == ["p0", "p1"]
    pg.set_weights({mid: rl_params_from_numpy(jax.device_get(w), device="cpu")
                    for mid, w in jg.get_weights().items()})
    rng = np.random.default_rng(5)
    subs = {}
    for mid, (obs_space, act_space) in spaces.items():
        rows = 24
        subs[mid] = {
            OBS: rng.standard_normal((rows, *obs_space.shape)).astype(np.float32),
            ACTIONS: rng.integers(0, act_space.n, rows),
            ACTION_LOGP: np.log(rng.uniform(0.2, 0.6, rows)).astype(np.float32),
            ADVANTAGES: rng.standard_normal(rows).astype(np.float32),
            VALUE_TARGETS: rng.standard_normal(rows).astype(np.float32),
        }
    ref = jg.update(jsb.MultiAgentBatch({m: jsb.SampleBatch(s) for m, s in subs.items()}, 24))
    got = pg.update(MultiAgentBatch({m: SampleBatch(s) for m, s in subs.items()}, 24))
    assert sorted(got) == sorted(ref)
    for mid in ref:
        for key in ref[mid]:
            assert abs(got[mid][key] - ref[mid][key]) < F32_TOL, (mid, key)
        errs = _tree_err(_port_weights(pg.get_weights()[mid]),
                         jax.device_get(jg.get_weights()[mid]))
        assert max(errs.values()) < PARAM_TOL, (mid, errs)
    state = pg.get_state()
    pg.update(MultiAgentBatch({m: SampleBatch(s) for m, s in subs.items()}, 24))
    pg.set_state(state)
    for mid in state:
        for a, b in zip(jax.tree_util.tree_leaves(state[mid]["params"]),
                        jax.tree_util.tree_leaves(pg.get_weights()[mid])):
            np.testing.assert_array_equal(a, b)


def test_multi_rl_module_keeps_the_reference_structure():
    specs = {m: (jrl.RLModuleSpec(model_config={"fcnet_hiddens": (8,)}),
                 prl.RLModuleSpec(model_config={"fcnet_hiddens": (8,)})) for m in ("b", "a")}
    obs = {m: CARTPOLE[0] for m in specs}
    act = {m: CARTPOLE[1] for m in specs}
    jm = jmrm.MultiRLModuleSpec({m: s[0] for m, s in specs.items()}).build(obs, act)
    pm = pmrm.MultiRLModuleSpec({m: s[1] for m, s in specs.items()}).build(obs, act,
                                                                          device="cpu")
    assert "a" in pm and sorted(pm.keys()) == sorted(jm.keys())
    ref = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    own = rl_params_to_numpy(pm.init_params(0))
    assert list(own) == sorted(specs)
    shapes = lambda tree: [(jax.tree_util.keystr(p), np.shape(x))
                           for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert shapes(own) == shapes(ref)
    # The modules draw in turn from one generator: different parameters.
    assert not np.array_equal(own["a"]["pi"][0]["w"], own["b"]["pi"][0]["w"])
