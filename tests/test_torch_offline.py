"""The port's offline RL (``ray_tpu_torch/rllib/offline/offline_data.py``,
``algorithms/bc``, ``marwil``, ``cql``) against the JAX package's, on the
CPU.

* ``OfflineData``: the epoch order from one seed, bit for bit; JSON, JSONL
  and parquet files (a file, a directory) and a dataset read into the
  reference's columns, the reference reading them through its data
  runtime (a local cluster, ``ray_start_shared``).
* ``compute_returns_to_go`` bit for bit, with episode ids, with
  terminateds and with neither.
* BC's and MARWIL's loss, metrics and gradients at the f32 bounds (loss
  2e-5, gradients 2e-4).
* The refusals: BC and CQL without ``offline_data(input_=...)``, a dataset
  without the columns an algorithm needs.
* Learning at the reference's bars and budgets
  (``tests/test_rllib_extras.py:599-700, 765-870``): BC clones a scripted
  CartPole expert to 120, MARWIL clears 100 on half-random data, CQL beats
  BC on a skewed bandit dataset by 0.15 and reaches 0.6.
"""

import json

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl import (  # noqa: F401 (one_torch_thread is an autouse fixture)
    CARTPOLE, F32_TOL, PARAM_TOL, err, one_torch_thread, port_grads, to_port, tree_err,
)
from ray_tpu.rllib.algorithms.bc import bc as jbc
from ray_tpu.rllib.algorithms.marwil import marwil as jmarwil
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu.rllib.offline import offline_data as joff
from ray_tpu.rllib.policy import sample_batch as jsb
from ray_tpu_torch.rllib.algorithms.bc import bc as pbc
from ray_tpu_torch.rllib.algorithms.marwil import marwil as pmarwil
from ray_tpu_torch.rllib.core import rl_module as prl
from ray_tpu_torch.rllib.offline import OfflineData
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS, EPS_ID, OBS, REWARDS, SampleBatch, TERMINATEDS,
)


# -- OfflineData -------------------------------------------------------------------
def test_offline_data_draws_the_reference_order():
    rng = np.random.default_rng(0)
    data = {OBS: rng.standard_normal((37, 4)).astype(np.float32), ACTIONS: np.arange(37)}
    ref, port = joff.OfflineData(jsb.SampleBatch(data), 5), OfflineData(SampleBatch(data), 5)
    assert len(port) == len(ref) == 37 and sorted(port.columns) == sorted(ref.columns)
    seen = set()
    for size in (8, 8, 8, 8, 8, 3, 16, 16, 1):  # wraps the epoch three times
        got, want = port.sample(size), ref.sample(size)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        seen.update(got[ACTIONS].tolist())
    assert seen == set(range(37))


def _rows(n=24, seed=0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"obs": [float(x) for x in rng.standard_normal(4)], "actions": int(rng.integers(2)),
             "rewards": float(rng.standard_normal()), "terminateds": bool(i % 7 == 6)}
            for i in range(n)]


def _write(tmp_path, kind: str, rows) -> str:
    if kind == "parquet":
        import pyarrow as pa
        import pyarrow.parquet as pq

        directory = tmp_path / "parquet"
        directory.mkdir()
        for part in range(2):
            chunk = rows[part * len(rows) // 2:(part + 1) * len(rows) // 2]
            pq.write_table(pa.Table.from_pylist(chunk), directory / f"part-{part}.parquet")
        return str(directory)
    path = tmp_path / f"rows.{kind}"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


@pytest.mark.parametrize("kind", ["json", "jsonl", "parquet", "dataset"])
def test_offline_inputs_read_the_reference_columns(kind, tmp_path, ray_start_shared):
    rows = _rows()
    if kind == "dataset":
        from ray_tpu import data as rt_data

        source = rt_data.from_items(rows)
    else:
        source = _write(tmp_path, kind, rows)
    ref = joff.OfflineData(source)._batch
    got = OfflineData(source)._batch
    assert sorted(got) == sorted(ref) == sorted(rows[0])
    if kind == "parquet":
        # The reference reads the two files in tasks and takes their blocks
        # in the order the tasks finish (ROADMAP Queue C item 19): compare
        # the rows in one order, by their observations.
        ref, got = ({k: v[np.lexsort(b[OBS].T)] for k, v in b.items()} for b in (ref, got))
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        if got[key].dtype == np.float64 and kind in ("json", "jsonl"):
            # pandas' default JSON float parser (the reference's reader) is
            # not correctly rounded: its f64 values differ from Python's in
            # the last bits; the f32 values the learner takes are equal.
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-14, atol=1e-15)
            np.testing.assert_array_equal(got[key].astype(np.float32),
                                          ref[key].astype(np.float32))
        else:
            np.testing.assert_array_equal(got[key], ref[key])
    assert got[OBS].shape == (24, 4)


def test_offline_input_refusals(tmp_path):
    with pytest.raises(TypeError, match="unsupported offline input"):
        OfflineData(42)
    with pytest.raises(FileNotFoundError):
        OfflineData(str(tmp_path / "missing" / "*.parquet"))
    (tmp_path / "empty.jsonl").write_text("")
    with pytest.raises(ValueError, match="empty"):
        OfflineData(str(tmp_path / "empty.jsonl"))


# -- returns-to-go ------------------------------------------------------------------
@pytest.mark.parametrize("bounds", ["eps_id", "terminateds", "none"])
def test_returns_to_go_match_the_reference_bitwise(bounds):
    rng = np.random.default_rng(4)
    n = 60
    data = {REWARDS: rng.standard_normal(n).astype(np.float32)}
    if bounds == "eps_id":
        data[EPS_ID] = np.repeat([3, 9, 4, 11], [10, 25, 5, 20])
    elif bounds == "terminateds":
        data[TERMINATEDS] = rng.random(n) < 0.1
    got = pmarwil.compute_returns_to_go(SampleBatch(data), 0.97)
    ref = jmarwil.compute_returns_to_go(jsb.SampleBatch(data), 0.97)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_returns_to_go_math():
    """tests/test_rllib_extras.py:638-646."""
    batch = SampleBatch({REWARDS: np.array([1.0, 1.0, 1.0, 2.0], np.float32),
                         EPS_ID: np.array([1, 1, 1, 2])})
    np.testing.assert_allclose(pmarwil.compute_returns_to_go(batch, gamma=0.5),
                               [1 + 0.5 + 0.25, 1.5, 1.0, 2.0])


# -- losses and gradients ---------------------------------------------------------------
LEARNERS = {
    "bc": (jbc.BCLearner, pbc.BCLearner, {}),
    "marwil": (jmarwil.MARWILLearner, pmarwil.MARWILLearner,
               {"beta": 1.0, "vf_coeff": 0.5, "advantage_clip": 2.0}),
}
SPACES = {"discrete": CARTPOLE,
          "continuous": (CARTPOLE[0], gym.spaces.Box(-1, 1, (2,), np.float32))}


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("kind", LEARNERS)
def test_loss_and_gradients_match_jax(kind, space):
    jcls, pcls, config = LEARNERS[kind]
    obs_space, act_space = SPACES[space]
    model = {"fcnet_hiddens": (16, 16)}
    jl = jcls(jrl.RLModuleSpec(model_config=model).build(obs_space, act_space), config)
    pl = pcls(prl.RLModuleSpec(model_config=model).build(obs_space, act_space, device="cpu"),
              config, device="cpu")
    pl.set_weights(to_port(jl.params))
    rng = np.random.default_rng(6)
    rows = 40
    batch = {OBS: rng.standard_normal((rows, 4)).astype(np.float32),
             pmarwil.RETURNS: (5 * rng.standard_normal(rows)).astype(np.float32)}
    if space == "discrete":
        batch[ACTIONS] = rng.integers(0, 2, rows)
    else:
        batch[ACTIONS] = rng.uniform(-1, 1, (rows, 2)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(jl.compute_loss, has_aux=True)(
        jl.params, jbatch)
    with torch.no_grad():
        loss, metrics = pl.compute_loss(pl.params, pl._device_batch(SampleBatch(batch)))
    assert sorted(metrics) == sorted(ref_metrics)
    assert err(loss, ref_loss) < F32_TOL
    for key in ref_metrics:
        assert err(metrics[key], ref_metrics[key]) < F32_TOL, key
    if kind == "marwil":  # the clip binds on some rows
        assert float(metrics["mean_weight"]) != pytest.approx(1.0)
    errs = tree_err(port_grads(pl, SampleBatch(batch)), jax.device_get(ref_grads))
    assert max(errs.values()) < PARAM_TOL, errs


# -- refusals -------------------------------------------------------------------------
def test_offline_algorithms_require_their_input():
    from ray_tpu_torch.rllib import BCConfig, CQLConfig, MARWILConfig

    with pytest.raises(ValueError, match="offline_data"):
        BCConfig().environment("CartPole-v1").build_algo(device="cpu")
    with pytest.raises(ValueError, match="offline_data"):
        CQLConfig().environment(_BanditEnv).build_algo(device="cpu")
    obs_only = {OBS: np.zeros((8, 4), np.float32)}
    with pytest.raises(ValueError, match="lacks columns"):
        BCConfig().environment("CartPole-v1").offline_data(input_=obs_only).build_algo(
            device="cpu")
    no_rewards = {**obs_only, ACTIONS: np.zeros(8, np.int64)}
    with pytest.raises(ValueError, match="rewards"):
        MARWILConfig().environment("CartPole-v1").offline_data(input_=no_rewards).build_algo(
            device="cpu")
    with pytest.raises(ValueError, match="lacks columns"):
        CQLConfig().environment(_BanditEnv).offline_data(input_=no_rewards).build_algo(
            device="cpu")


# -- learning at the reference's bars -----------------------------------------------------
def _cartpole_expert_rows(n_steps=4000, seed=0):
    """Scripted near-expert CartPole policy (tests/test_rllib_extras.py:546-564)."""
    env = gym.make("CartPole-v1")
    rng = np.random.default_rng(seed)
    rows = []
    obs, _ = env.reset(seed=seed)
    while len(rows) < n_steps:
        action = int(obs[2] + 0.5 * obs[3] > 0)
        if rng.random() < 0.05:  # tiny noise for coverage
            action = 1 - action
        rows.append({"obs": np.asarray(obs, np.float32), "actions": action})
        obs, _, term, trunc, _ = env.step(action)
        if term or trunc:
            obs, _ = env.reset()
    env.close()
    return rows


def test_bc_clones_expert():
    from ray_tpu_torch.rllib import BCConfig

    rows = _cartpole_expert_rows()
    batch = SampleBatch({"obs": np.stack([r["obs"] for r in rows]),
                         "actions": np.asarray([r["actions"] for r in rows])})
    algo = (BCConfig().environment("CartPole-v1").offline_data(input_=batch)
            .training(lr=1e-3, train_batch_size=256, updates_per_iteration=150,
                      model={"fcnet_hiddens": (64, 64)})
            .build_algo(device="cpu"))
    try:
        best = -np.inf
        for _ in range(8):
            result = algo.train()
            assert np.isfinite(result["learner/total_loss"])
            best = max(best, algo.evaluate()["episode_return_mean"])
            if best >= 120.0:
                break
        assert best >= 120.0, f"BC failed to clone the expert: best={best}"
    finally:
        algo.stop()


def test_marwil_outperforms_its_dataset_floor():
    from ray_tpu_torch.rllib import MARWILConfig

    env = gym.make("CartPole-v1")
    rng = np.random.default_rng(0)
    rows_obs, rows_act, rows_rew, rows_eps = [], [], [], []
    for eps, kind in enumerate(("expert",) * 6 + ("random",) * 6):
        obs, _ = env.reset(seed=int(rng.integers(1 << 30)))
        done = False
        while not done:
            action = int(obs[2] + 0.5 * obs[3] > 0) if kind == "expert" else int(rng.integers(0, 2))
            rows_obs.append(np.asarray(obs, np.float32))
            rows_act.append(action)
            obs, reward, term, trunc, _ = env.step(action)
            rows_rew.append(np.float32(reward))
            rows_eps.append(eps)
            done = term or trunc
    env.close()
    batch = SampleBatch({"obs": np.stack(rows_obs), "actions": np.asarray(rows_act),
                         "rewards": np.asarray(rows_rew), "eps_id": np.asarray(rows_eps)})
    algo = (MARWILConfig().environment("CartPole-v1").offline_data(input_=batch)
            .training(lr=1e-3, train_batch_size=256, updates_per_iteration=150, beta=1.0,
                      model={"fcnet_hiddens": (64, 64)})
            .build_algo(device="cpu"))
    try:
        best = -np.inf
        for _ in range(8):
            result = algo.train()
            assert np.isfinite(result["learner/total_loss"])
            best = max(best, algo.evaluate()["episode_return_mean"])
            if best >= 100.0:
                break
        assert best >= 100.0, f"MARWIL failed: best={best}"
    finally:
        algo.stop()


class _BanditEnv:
    """1-step continuous bandit: r(a) = 1 - |a - 0.5| (spaces probe)."""

    def __init__(self, _cfg=None):
        self.observation_space = gym.spaces.Box(-1, 1, shape=(3,), dtype=np.float32)
        self.action_space = gym.spaces.Box(-1, 1, shape=(1,), dtype=np.float32)

    def close(self):
        pass


def _skewed_bandit_dataset(n=4000, seed=0):
    """Mostly bad behaviour (a ~ U[-1, 0]) with thin coverage of the good
    region (tests/test_rllib_extras.py:783-801)."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    bad = rng.uniform(-1, 0, size=(n, 1))
    good = rng.uniform(0, 1, size=(n, 1))
    actions = np.where(rng.uniform(size=(n, 1)) < 0.85, bad, good).astype(np.float32)
    rewards = (1.0 - np.abs(actions[:, 0] - 0.5)).astype(np.float32)
    return {"obs": obs, "actions": actions, "rewards": rewards, "new_obs": obs,
            "terminateds": np.ones(n, dtype=bool)}


def _bandit_policy_reward(module, params, seed=1):
    rng = np.random.default_rng(seed)
    obs = torch.from_numpy(rng.uniform(-1, 1, size=(256, 3)).astype(np.float32))
    with torch.no_grad():
        actions = np.clip(module.forward_inference(params, obs).numpy(), -1, 1)
    return float(np.mean(1.0 - np.abs(actions[:, 0] - 0.5)))


def test_cql_beats_bc_on_skewed_dataset():
    from ray_tpu_torch.rllib import BCConfig, CQLConfig

    data = SampleBatch(_skewed_bandit_dataset())
    bc = (BCConfig().environment(_BanditEnv).offline_data(input_=data)
          .training(lr=1e-3, train_batch_size=256, updates_per_iteration=200,
                    model={"fcnet_hiddens": (64, 64)})
          .debugging(seed=0).build_algo(device="cpu"))
    try:
        for _ in range(3):
            bc.train()
        learner = bc.learner_group.local_learner
        bc_reward = _bandit_policy_reward(learner.module, learner.params)
    finally:
        bc.stop()
    cql = (CQLConfig().environment(_BanditEnv).offline_data(input_=data)
           .training(lr=1e-3, train_batch_size=256, cql_alpha=0.1, updates_per_iteration=300,
                     target_entropy=-2.0, initial_alpha=0.5, model={"fcnet_hiddens": (64, 64)})
           .debugging(seed=0).build_algo(device="cpu"))
    try:
        learner = cql.learner_group.local_learner
        cql_reward, last = -np.inf, {}
        for _ in range(6):
            last = cql.train()
            cql_reward = max(cql_reward, _bandit_policy_reward(learner.module, learner.params))
        assert np.isfinite(last["learner/critic_loss"]) and "learner/cql_penalty" in last
    finally:
        cql.stop()
    assert cql_reward > bc_reward + 0.15, (bc_reward, cql_reward)
    assert cql_reward >= 0.6, cql_reward
