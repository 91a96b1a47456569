"""The port's RL modules (``ray_tpu_torch/rllib/core/rl_module.py``) against
the JAX package's (``ray_tpu/rllib/core/rl_module.py``), f32 on the CPU.

Parameters come from the JAX init (``jax.device_get`` of the tree) and go
through ``convert.rl_params_from_numpy``; gradients come back through
``rl_params_to_numpy``. Observations, actions and batches are made with
numpy from a seed. Each module class is held on ``forward_train``,
``forward_inference``, ``action_logp`` and the gradient of PPO's loss
(the JAX ``PPOLearner.compute_loss`` against the port's) with respect to
every parameter leaf: ``MLPModule`` with Discrete and Box actions,
``ConvModule`` on uint8 [84, 84, 4] (the Atari stack) and on a non-square
[60, 80, 3], ``LSTMModule`` with a done inside a window and a row count
that ``max_seq_len`` does not divide. Bounds as ROADMAP's parity rules set
them for f32: forward 2e-5, gradients 2e-4, as max |port - JAX| over
max(1, max |JAX|). Sampling draws from another generator than JAX's
threefry, so ``forward_exploration`` is held by its distribution.
"""

import subprocess
import sys
from pathlib import Path

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms.ppo import ppo as jppo
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu_torch.models.convert import rl_params_from_numpy, rl_params_to_numpy
from ray_tpu_torch.rllib.algorithms.ppo import ppo as pppo
from ray_tpu_torch.rllib.core import rl_module as prl
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTION_LOGP, ACTIONS, ADVANTAGES, OBS, TERMINATEDS, TRUNCATEDS, VALUE_TARGETS,
)
from ray_tpu_torch.train.step import named_leaves

ROOT = Path(__file__).resolve().parent.parent
F32_TOL = 2e-5
GRAD_F32_TOL = 2e-4
ROWS = 10

# name -> (observation space, action space, model_config)
CASES = {
    "mlp_discrete": (gym.spaces.Box(-1, 1, (4,), np.float32), gym.spaces.Discrete(2),
                     {"fcnet_hiddens": (16, 16)}),
    "mlp_box": (gym.spaces.Box(-1, 1, (3,), np.float32),
                gym.spaces.Box(-2, 2, (2,), np.float32), {"fcnet_hiddens": (16, 16)}),
    "conv_atari": (gym.spaces.Box(0, 255, (84, 84, 4), np.uint8), gym.spaces.Discrete(6), {}),
    "conv_60x80": (gym.spaces.Box(0, 255, (60, 80, 3), np.uint8), gym.spaces.Discrete(3),
                   {"post_fcnet_hiddens": (32,), "conv_activation": "tanh"}),
    "lstm": (gym.spaces.Box(-1, 1, (4,), np.float32), gym.spaces.Discrete(2),
             {"use_lstm": True, "fcnet_hiddens": (16,), "lstm_cell_size": 8,
              "max_seq_len": 4}),
    "lstm_box": (gym.spaces.Box(-1, 1, (3,), np.float32),
                 gym.spaces.Box(-1, 1, (2,), np.float32),
                 {"use_lstm": True, "fcnet_hiddens": (16,), "lstm_cell_size": 8,
                  "max_seq_len": 4}),
}


def _err(port, ref) -> float:
    """max |port - ref| over max(1, max |ref|)."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(port - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def _modules(name, seed=0):
    obs_space, act_space, model = CASES[name]
    jmod = jrl.RLModuleSpec(model_config=model).build(obs_space, act_space)
    pmod = prl.RLModuleSpec(model_config=model).build(obs_space, act_space, device="cpu")
    assert type(pmod).__name__ == type(jmod).__name__
    jparams = jmod.init_params(jax.random.PRNGKey(seed))
    pparams = rl_params_from_numpy(jax.device_get(jparams), device="cpu")
    return jmod, pmod, jparams, pparams


def _obs(space, rows, seed):
    rng = np.random.default_rng(seed)
    if space.dtype == np.uint8:
        return rng.integers(0, 256, (rows, *space.shape), dtype=np.uint8)
    return rng.standard_normal((rows, *space.shape)).astype(np.float32)


def _actions(space, rows, seed):
    rng = np.random.default_rng(seed + 1)
    if hasattr(space, "n"):
        return rng.integers(0, space.n, rows)
    return rng.standard_normal((rows, *space.shape)).astype(np.float32)


def _batch(name, rows=ROWS, seed=0) -> dict:
    obs_space, act_space, _ = CASES[name]
    rng = np.random.default_rng(seed + 2)
    dones = np.zeros(rows, bool)
    dones[[1, 6]] = True  # inside the first and the second window of 4
    return {
        OBS: _obs(obs_space, rows, seed),
        ACTIONS: _actions(act_space, rows, seed),
        ACTION_LOGP: (-rng.random(rows)).astype(np.float32),
        ADVANTAGES: rng.standard_normal(rows).astype(np.float32),
        VALUE_TARGETS: rng.standard_normal(rows).astype(np.float32),
        TERMINATEDS: dones,
        TRUNCATEDS: np.zeros(rows, bool),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _dones(name, batch):
    return batch[TERMINATEDS] | batch[TRUNCATEDS] if "lstm" in name else None


@pytest.mark.parametrize("name", CASES)
def test_forward_train_matches_jax(name):
    jmod, pmod, jparams, pparams = _modules(name)
    batch = _batch(name)
    kwargs_j, kwargs_p = {}, {}
    if "lstm" in name:
        kwargs_j = {"dones": jnp.asarray(_dones(name, batch))}
        kwargs_p = {"dones": torch.from_numpy(_dones(name, batch))}
    ref = jmod.forward_train(jparams, jnp.asarray(batch[OBS]), **kwargs_j)
    with torch.no_grad():
        out = pmod.forward_train(pparams, torch.from_numpy(batch[OBS]), **kwargs_p)
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert tuple(out[key].shape) == tuple(ref[key].shape), key
        assert _err(out[key], ref[key]) < F32_TOL, key


@pytest.mark.parametrize("name", CASES)
def test_forward_inference_and_action_logp_match_jax(name):
    jmod, pmod, jparams, pparams = _modules(name, seed=1)
    batch = _batch(name, seed=3)
    obs, actions = batch[OBS], batch[ACTIONS]
    dones = _dones(name, batch)
    with torch.no_grad():
        if "lstm" in name:
            state = jmod.initial_state(ROWS)
            ref_act, ref_state = jmod.forward_inference(jparams, jnp.asarray(obs), state)
            act, new_state = pmod.forward_inference(pparams, torch.from_numpy(obs))
            for a, b in zip(new_state, ref_state):
                assert _err(a, b) < F32_TOL
            ref = jmod.action_logp(jparams, jnp.asarray(obs), jnp.asarray(actions),
                                   dones=jnp.asarray(dones))
            got = pmod.action_logp(pparams, torch.from_numpy(obs), torch.from_numpy(actions),
                                   dones=torch.from_numpy(dones))
        else:
            ref_act = jmod.forward_inference(jparams, jnp.asarray(obs))
            act = pmod.forward_inference(pparams, torch.from_numpy(obs))
            ref = jmod.action_logp(jparams, jnp.asarray(obs), jnp.asarray(actions))
            got = pmod.action_logp(pparams, torch.from_numpy(obs), torch.from_numpy(actions))
    if pmod.discrete:
        np.testing.assert_array_equal(act.numpy(), np.asarray(ref_act))
    else:
        assert _err(act, ref_act) < F32_TOL
    for a, b, what in zip(got, ref, ("logp", "entropy", "vf")):
        assert tuple(a.shape) == tuple(b.shape), what
        assert _err(a, b) < F32_TOL, what


def test_lstm_rollout_steps_thread_the_state_as_jax_does():
    jmod, pmod, jparams, pparams = _modules("lstm", seed=2)
    state_j, state_p = jmod.initial_state(3), pmod.initial_state(3)
    for step in range(4):
        obs = _obs(CASES["lstm"][0], 3, seed=10 + step)
        act_j, state_j = jmod.forward_inference(jparams, jnp.asarray(obs), state_j)
        with torch.no_grad():
            act_p, state_p = pmod.forward_inference(pparams, torch.from_numpy(obs), state_p)
        np.testing.assert_array_equal(act_p.numpy(), np.asarray(act_j))
        for a, b in zip(state_p, state_j):
            assert _err(a, b) < F32_TOL


@pytest.mark.parametrize("name", CASES)
def test_ppo_loss_gradient_matches_jax(name):
    jmod, pmod, jparams, pparams = _modules(name, seed=4)
    config = {"clip_param": 0.2, "vf_clip_param": 10.0, "vf_loss_coeff": 0.5,
              "entropy_coeff": 0.01}
    jlearner = jppo.PPOLearner(jmod, config)
    plearner = pppo.PPOLearner(pmod, config, device="cpu")
    batch = _batch(name, seed=5)
    (ref_loss, _), ref_grads = jax.value_and_grad(jlearner.compute_loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(pparams)]
    loss, _ = plearner.compute_loss(pparams, _torch_batch(batch))
    assert _err(loss, ref_loss) < F32_TOL
    grad_tree = _replace_leaves(pparams, iter(torch.autograd.grad(loss, leaves)))
    port_grads = dict(jax.tree_util.tree_flatten_with_path(rl_params_to_numpy(grad_tree))[0])
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(flat_ref) == len(port_grads)
    for path, ref in flat_ref:
        assert port_grads[path].shape == np.shape(ref), path
        assert _err(port_grads[path], ref) < GRAD_F32_TOL, path


def _replace_leaves(tree, values):
    """The tree with its leaves replaced, in ``named_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, values) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replace_leaves(v, values) for v in tree]
    return next(values)


@pytest.mark.parametrize("name", ["mlp_discrete", "mlp_box", "conv_atari", "lstm"])
def test_conversion_round_trip(name):
    _, pmod, jparams, pparams = _modules(name)
    tree = jax.device_get(jparams)
    back = rl_params_to_numpy(pparams)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf), err_msg=str(path))
    # The port's own init has the reference's structure and shapes.
    own = jax.tree_util.tree_flatten_with_path(rl_params_to_numpy(pmod.init_params(0)))[0]
    assert [(p, a.shape) for p, a in own] == [(p, np.shape(a)) for p, a in flat]


def test_conv_weights_are_oihw_and_trunk_rows_keep_the_reference_order():
    _, pmod, jparams, pparams = _modules("conv_60x80")
    assert pmod.conv_out_hw == (4, 6)
    assert tuple(pparams["conv"][0]["w"].shape) == (32, 3, 8, 8)
    np.testing.assert_array_equal(pparams["trunk"][0]["w"].numpy(),
                                  np.asarray(jparams["trunk"][0]["w"]))


def test_init_draws_the_reference_scales():
    # He-normal: the std of a layer's weights is sqrt(2 / fan_in).
    _, pmod, _, _ = _modules("conv_atari")
    params = pmod.init_params(3)
    for layer, fan_in in zip(params["conv"], (8 * 8 * 4, 4 * 4 * 32, 3 * 3 * 64)):
        std = float(layer["w"].std())
        assert abs(std / np.sqrt(2.0 / fan_in) - 1) < 0.05
        assert not layer["b"].any()
    assert torch.equal(params["trunk"][0]["w"], pmod.init_params(3)["trunk"][0]["w"])


SAMPLES = 20000


def _repeat(obs, n):
    return np.repeat(obs, n, axis=0)


def _one_step(name, pmod, params, obs):
    """forward_train on rows that each start from a zero state (an LSTM's
    recurrence reset at every row), as forward_exploration with no state."""
    dones = {"dones": torch.ones(len(obs), dtype=torch.bool)} if "lstm" in name else {}
    return pmod.forward_train(params, obs, **dones), dones


@pytest.mark.parametrize("name", ["mlp_discrete", "conv_60x80", "lstm"])
def test_categorical_exploration_follows_softmax(name):
    """Each row's action frequencies over SAMPLES draws against its softmax
    probabilities: |freq - p| < 5 sqrt(p (1 - p) / SAMPLES) + 1e-3 for every
    action (a five-sigma band; a sampler off by a temperature or an
    off-by-one action misses it by far)."""
    _, pmod, _, pparams = _modules(name, seed=6)
    rows = 2
    obs = _obs(CASES[name][0], rows, seed=7)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        big = torch.from_numpy(_repeat(obs, SAMPLES))
        out = pmod.forward_exploration(pparams, big, gen)
        actions, logp = out[0], out[1]
        fwd, _ = _one_step(name, pmod, pparams, torch.from_numpy(obs))
        probs = torch.softmax(fwd["logits"], -1)
        ref_logp = pmod.action_logp(pparams, big, actions, **_one_step(name, pmod, pparams,
                                                                        big)[1])[0]
    assert torch.allclose(logp, ref_logp, atol=1e-6)
    actions = actions.numpy().reshape(rows, SAMPLES)
    for r in range(rows):
        p = probs[r].numpy().astype(np.float64)
        freq = np.bincount(actions[r], minlength=len(p)) / SAMPLES
        band = 5 * np.sqrt(p * (1 - p) / SAMPLES) + 1e-3
        assert np.all(np.abs(freq - p) < band), (freq, p)


@pytest.mark.parametrize("name", ["mlp_box", "lstm_box"])
def test_gaussian_exploration_follows_mean_and_std(name):
    """Each row's sample mean within 5 std / sqrt(SAMPLES) of the head's
    mean, and its sample std within 5 / sqrt(2 SAMPLES) relative of exp(log_std)."""
    _, pmod, _, pparams = _modules(name, seed=8)
    rows = 2
    obs = _obs(CASES[name][0], rows, seed=9)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        big = torch.from_numpy(_repeat(obs, SAMPLES))
        out = pmod.forward_exploration(pparams, big, gen)
        actions, logp = out[0], out[1]
        fwd, _ = _one_step(name, pmod, pparams, torch.from_numpy(obs))
        ref_logp = pmod.action_logp(pparams, big, actions, **_one_step(name, pmod, pparams,
                                                                        big)[1])[0]
    assert torch.allclose(logp, ref_logp, atol=1e-5)
    actions = actions.numpy().reshape(rows, SAMPLES, -1)
    for r in range(rows):
        mean, std = fwd["mean"][r].numpy(), np.exp(fwd["log_std"][r].numpy())
        assert np.all(np.abs(actions[r].mean(0) - mean) < 5 * std / np.sqrt(SAMPLES))
        assert np.all(np.abs(actions[r].std(0) / std - 1) < 5 / np.sqrt(2 * SAMPLES))


def test_spec_picks_the_reference_catalog():
    box, disc = gym.spaces.Box(0, 255, (84, 84, 4), np.uint8), gym.spaces.Discrete(6)
    assert isinstance(prl.RLModuleSpec().build(box, disc, device="cpu"), prl.ConvModule)
    small = gym.spaces.Box(0, 255, (8, 8, 3), np.uint8)
    assert type(prl.RLModuleSpec().build(small, disc, device="cpu")) is prl.MLPModule
    assert isinstance(prl.RLModuleSpec(model_config={"use_lstm": True}).build(
        gym.spaces.Box(-1, 1, (4,)), disc, device="cpu"), prl.LSTMModule)
    with pytest.raises(ValueError, match="below 1x1"):
        prl.RLModuleSpec(model_config={"conv_filters": [[8, 8, 4]] * 3}).build(
            gym.spaces.Box(0, 255, (20, 20, 1), np.uint8), disc, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from ray_tpu_torch.rllib import LearnerGroup, PPOConfig, RLModuleSpec

    obs, act = CASES["mlp_discrete"][:2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RLModuleSpec().build(obs, act)
    module = RLModuleSpec().build(obs, act, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pppo.PPOLearner(module, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LearnerGroup(pppo.PPOLearner, RLModuleSpec(), obs, act, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPOConfig().environment("CartPole-v1").build_algo()


def test_learner_half_imports_without_gymnasium():
    """rl_module, learner, the algorithms (and the package) import where
    gymnasium cannot be imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'gymnasium':\n"
        "            raise ImportError('gymnasium is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import ray_tpu_torch.rllib.core.rl_module, ray_tpu_torch.rllib.core.learner\n"
        "import ray_tpu_torch.rllib.algorithms.ppo.ppo, ray_tpu_torch.rllib\n"
        "import ray_tpu_torch.rllib.algorithms.sac.sac, ray_tpu_torch.rllib.algorithms.cql.cql\n"
        "import ray_tpu_torch.rllib.algorithms.appo.appo, ray_tpu_torch.rllib.algorithms.dqn.dqn\n"
        "import ray_tpu_torch.rllib.algorithms.marwil.marwil\n"
        "import ray_tpu_torch.rllib.env.multi_agent_env_runner\n"
        "assert 'gymnasium' not in sys.modules\n"
        "try:\n"
        "    import gymnasium\n"
        "except ImportError:\n"
        "    print('blocked')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "blocked"
