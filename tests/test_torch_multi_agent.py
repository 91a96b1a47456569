"""The port's multi-agent RLlib (``ray_tpu_torch/rllib/env/multi_agent_env.py``,
``multi_agent_env_runner.py``, and the multi-agent paths of
``algorithms/algorithm.py`` and ``ppo/ppo.py``) against the JAX package's,
on the CPU.

* ``MultiAgentCartPole`` gives the reference's observations, rewards and
  dones for the same seed and actions.
* ``MultiAgentEnvRunner`` with greedy actions from the same weights: the
  reference's fragment, column by column, over episode ends, for two
  modules and for one module shared by two agents (each agent's episode
  contiguous); episode ids from ``worker_index * 10_000_000``.
* Both refusals: recurrent modules and stateful env→module connectors.
* One multi-agent PPO ``training_step`` on fixed fragments (per-module GAE
  with its bootstrap calls, the epochs in ``default_rng(iteration)``
  order, the weight sync) against the reference's parameters afterwards.
* Through ``PPOConfig().multi_agent(...).build_algo``: runners in gang
  processes, ``evaluate``, the checkpoint round trip
  (``tests/test_rllib_extras.py:412-443``), and learning to 150 (the sum
  of both agents' returns) at the reference's configuration and budget
  (``tests/test_rllib_extras.py:376-409``).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_rl import (  # noqa: F401 (one_torch_thread is an autouse fixture)
    CARTPOLE, PARAM_TOL, one_torch_thread, to_port, to_ref, tree_err,
)
from ray_tpu.rllib.algorithms.ppo import ppo as jppo
from ray_tpu.rllib.core import learner as jlearner
from ray_tpu.rllib.core import multi_rl_module as jmrm
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu.rllib.env import multi_agent_env as jmae
from ray_tpu.rllib.env import multi_agent_env_runner as jmar
from ray_tpu.rllib.policy import sample_batch as jsb
from ray_tpu_torch.rllib.algorithms.ppo import ppo as pppo
from ray_tpu_torch.rllib.core import learner as plearner
from ray_tpu_torch.rllib.core import multi_rl_module as pmrm
from ray_tpu_torch.rllib.core import rl_module as prl
from ray_tpu_torch.rllib.env import multi_agent_env as pmae
from ray_tpu_torch.rllib.env import multi_agent_env_runner as pmar
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTION_LOGP, ACTIONS, EPS_ID, NEXT_OBS, OBS, REWARDS, MultiAgentBatch,
    SampleBatch, TERMINATEDS, TRUNCATEDS, VF_PREDS,
)


def _policy_for(agent_id, *args, **kwargs):
    return "p0" if agent_id.endswith("0") else "p1"


def _shared(agent_id, *args, **kwargs):
    return "shared"


def _env(package, num_agents=2):
    return (jmae if package == "jax" else pmae).MultiAgentCartPole({"num_agents": num_agents})


def test_multi_agent_cartpole_steps_as_the_reference():
    envs = [_env("jax", 3), _env("port", 3)]
    assert envs[1].possible_agents == envs[0].possible_agents
    for agent in envs[0].possible_agents:
        assert envs[1].get_observation_space(agent) == envs[0].get_observation_space(agent)
        assert envs[1].get_action_space(agent) == envs[0].get_action_space(agent)
    outs = [[env.reset(seed=7)[0]] for env in envs]
    rng = np.random.default_rng(0)
    for _ in range(60):
        actions = {a: int(rng.integers(2)) for a in envs[0].possible_agents}
        for env, out in zip(envs, outs):
            out.append(env.step(actions)[:4])
    for ref, got in zip(*outs):
        if isinstance(ref, dict):  # the reset observations
            ref, got = (ref,), (got,)
        for r, g in zip(ref, got):
            assert sorted(g) == sorted(r)
            for key in r:
                np.testing.assert_array_equal(g[key], r[key])
    assert outs[0][-1][2]["__all__"]  # every agent ended within 60 steps
    for env in envs:
        env.close()


# -- the runner --------------------------------------------------------------------
SPECS = {"two_modules": (_policy_for, ("p0", "p1")), "shared": (_shared, ("shared",))}


def _runners(mapping, mids, worker_index):
    model = {"fcnet_hiddens": (8,)}
    kwargs = dict(policy_mapping_fn=mapping, rollout_fragment_length=40, seed=3,
                  worker_index=worker_index, explore=False)
    ref = jmar.MultiAgentEnvRunner(
        lambda: _env("jax"), jmrm.MultiRLModuleSpec({m: jrl.RLModuleSpec(model_config=model)
                                                     for m in mids}), **kwargs)
    port = pmar.MultiAgentEnvRunner(
        lambda: _env("port"), pmrm.MultiRLModuleSpec({m: prl.RLModuleSpec(model_config=model)
                                                      for m in mids}), **kwargs)
    weights = ref.module.init_params(jax.random.PRNGKey(1))
    ref.set_weights(weights)
    port.set_weights({mid: to_port(w) for mid, w in weights.items()})
    return ref, port


@pytest.mark.parametrize("spec", SPECS)
def test_runner_fragments_match_the_reference(spec):
    mapping, mids = SPECS[spec]
    ref, port = _runners(mapping, mids, worker_index=2)
    for _ in range(3):  # 120 env steps: several episodes end
        want, got = ref.sample(), port.sample()
        assert got.env_steps() == want.env_steps()
        assert sorted(got.keys()) == sorted(want.keys()) == sorted(mids)
        for mid in mids:
            g, w = got[mid], want[mid]
            assert sorted(g) == sorted(w)
            for key in w:
                if key == ACTIONS:  # JAX's integers are int32 (x64 off), torch's int64
                    assert g[key].dtype == np.int64 and w[key].dtype == np.int32
                else:
                    assert g[key].dtype == w[key].dtype, (mid, key)
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{mid} {key}")
            ids = g[EPS_ID]
            # each agent's episode is one contiguous run, ids from the
            # worker's base
            assert np.count_nonzero(np.diff(ids)) == len(set(ids.tolist())) - 1
            assert (ids // 10_000_000 == 2).all()
    assert port.get_metrics() == ref.get_metrics()
    assert port.get_metrics()["num_episodes"] >= 2


def test_runner_refusals():
    from ray_tpu_torch.rllib.connectors import NormalizeObservations

    lstm = pmrm.MultiRLModuleSpec({"p0": prl.RLModuleSpec(model_config={"use_lstm": True}),
                                   "p1": None})
    with pytest.raises(ValueError, match="stateful"):
        pmar.MultiAgentEnvRunner(lambda: _env("port"), lstm, policy_mapping_fn=_policy_for)
    spec = pmrm.MultiRLModuleSpec({"p0": None, "p1": None})
    with pytest.raises(ValueError, match="stateful env_to_module"):
        pmar.MultiAgentEnvRunner(lambda: _env("port"), spec, policy_mapping_fn=_policy_for,
                                 env_to_module=NormalizeObservations)


# -- multi-agent PPO's training_step on fixed fragments --------------------------------
class _Fragments:
    def __init__(self, fragments, batch_cls, multi_cls):
        self._fragments = iter(fragments)
        self._batch_cls, self._multi_cls = batch_cls, multi_cls
        self.synced = []

    def sample(self):
        fragment, steps = next(self._fragments)
        return self._multi_cls({m: self._batch_cls({k: v.copy() for k, v in sub.items()})
                                for m, sub in fragment.items()}, steps)

    def sync_weights(self, params) -> None:
        self.synced.append(params)


def _fragment(seed, rows=48):
    rng = np.random.default_rng(seed)
    out = {}
    for i, mid in enumerate(("p0", "p1")):
        term = np.zeros(rows, bool)
        term[int(rng.integers(5, rows - 5))] = True
        eps = 100 * seed + 10 * i + np.cumsum(np.concatenate([[0], term[:-1]]))
        out[mid] = {
            OBS: rng.standard_normal((rows, 4)).astype(np.float32),
            NEXT_OBS: rng.standard_normal((rows, 4)).astype(np.float32),
            ACTIONS: rng.integers(0, 2, rows), REWARDS: np.ones(rows, np.float32),
            TERMINATEDS: term, TRUNCATEDS: np.zeros(rows, bool),
            ACTION_LOGP: np.log(rng.uniform(0.3, 0.7, rows)).astype(np.float32),
            VF_PREDS: rng.standard_normal(rows).astype(np.float32), EPS_ID: eps,
        }
    return out, rows


def test_multi_agent_training_step_matches_jax():
    from ray_tpu.rllib.algorithms.ppo.ppo import PPOConfig as JConfig
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig as PConfig

    fragments = [_fragment(seed) for seed in range(1, 4)]
    spaces = ({m: CARTPOLE[0] for m in ("p0", "p1")}, {m: CARTPOLE[1] for m in ("p0", "p1")})
    model = {"fcnet_hiddens": (16, 16)}
    algos = []
    for pkg, config_cls in (("jax", JConfig), ("port", PConfig)):
        config = (config_cls().environment("unused").multi_agent(
                  policies={"p0", "p1"}, policy_mapping_fn=_policy_for)
                  .training(lr=1e-3, train_batch_size=120, minibatch_size=32, num_epochs=2,
                            entropy_coeff=0.01, model=model))
        cls = jppo.PPO if pkg == "jax" else pppo.PPO
        algo = cls.__new__(cls)
        algo.config, algo.iteration, algo._total_env_steps = config, 0, 0
        algo.observation_space, algo.action_space = spaces
        if pkg == "jax":
            algo._multi_spec = jmrm.MultiRLModuleSpec(
                {m: jrl.RLModuleSpec(model_config=model) for m in ("p0", "p1")})
            algo.learner_group = jlearner.MultiAgentLearnerGroup(
                jppo.PPOLearner, algo._multi_spec, *spaces, algo._learner_config())
            algo.env_runner_group = _Fragments(fragments, jsb.SampleBatch, jsb.MultiAgentBatch)
        else:
            algo.device = torch.device("cpu")
            algo._multi_spec = pmrm.MultiRLModuleSpec(
                {m: prl.RLModuleSpec(model_config=model) for m in ("p0", "p1")})
            algo.learner_group = plearner.MultiAgentLearnerGroup(
                pppo.PPOLearner, algo._multi_spec, *spaces, algo._learner_config(),
                device="cpu")
            algo.learner_group.set_weights({m: to_port(w) for m, w in
                                            algos[0].learner_group.get_weights().items()})
            algo.env_runner_group = _Fragments(fragments, SampleBatch, MultiAgentBatch)
        algos.append(algo)
    ref = algos[0].training_step()
    got = algos[1].training_step()
    assert sorted(got) == sorted(ref)
    assert got["num_env_steps_trained"] == ref["num_env_steps_trained"] == 144
    for key in ref:
        assert abs(got[key] - ref[key]) / max(1.0, abs(ref[key])) < PARAM_TOL, key
    for mid in ("p0", "p1"):
        errs = tree_err(to_ref(algos[1].learner_group.get_weights()[mid]),
                        jax.device_get(algos[0].learner_group.get_weights()[mid]))
        assert max(errs.values()) < PARAM_TOL, (mid, errs)
    (synced,) = algos[1].env_runner_group.synced
    assert sorted(synced) == ["p0", "p1"]


# -- end to end -----------------------------------------------------------------------
def _config():
    from ray_tpu_torch.rllib import PPOConfig

    return (PPOConfig()
            .environment(pmae.MultiAgentCartPole, env_config={"num_agents": 2})
            .multi_agent(policies={"p0", "p1"}, policy_mapping_fn=_policy_for))


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, list):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [np.asarray(tree)]


def test_checkpoint_round_trip_and_evaluate(tmp_path):
    algo = (_config().env_runners(num_env_runners=1, rollout_fragment_length=64)
            .training(train_batch_size=128, minibatch_size=64, num_epochs=1,
                      model={"fcnet_hiddens": (16,)})
            .build_algo(device="cpu"))
    try:
        result = algo.train()
        assert result["num_env_steps_sampled_lifetime"] >= 128
        assert np.isfinite(result["learner/p0/total_loss"])
        path = algo.save(str(tmp_path / "ma_ckpt"))
        before = algo.learner_group.get_weights()
        algo.train()
        algo.restore(path)
        after = algo.learner_group.get_weights()
        for mid in ("p0", "p1"):
            for a, b in zip(_leaves(before[mid]), _leaves(after[mid]), strict=True):
                np.testing.assert_array_equal(a, b)
        out = algo.evaluate()
        assert out["num_episodes"] == 5 and out["episode_return_mean"] >= 16  # 2 agents x 8
    finally:
        algo.stop()


def test_multi_agent_config_refusals():
    from ray_tpu_torch.rllib import PPOConfig

    with pytest.raises(ValueError, match="MultiAgentEnv class"):
        PPOConfig().environment("CartPole-v1").multi_agent(policies={"p0"}).build_algo(
            device="cpu")
    with pytest.raises(ValueError, match="not in config.policies"):
        _config().multi_agent(policies={"p0", "x"}).build_algo(device="cpu")


def test_multi_agent_ppo_cartpole_learns_to_150():
    algo = (_config().env_runners(num_env_runners=2, rollout_fragment_length=128)
            .training(lr=3e-4, train_batch_size=2048, minibatch_size=256, num_epochs=8,
                      entropy_coeff=0.01, model={"fcnet_hiddens": (64, 64)})
            .debugging(seed=0)
            .build_algo(device="cpu"))
    try:
        best = -np.inf
        for _ in range(15):
            ret = algo.train()["episode_return_mean"]
            if not np.isnan(ret):
                best = max(best, ret)
            if best >= 150.0:  # sum of 2 agents ⇒ ~75 per agent
                break
        assert best >= 150.0, f"multi-agent PPO failed to learn: best={best}"
    finally:
        algo.stop()
