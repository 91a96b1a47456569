"""The port's RLlib end to end on the CPU (``device="cpu"``): PPO through
``PPOConfig().build_algo``, env runners in gang processes, the learner in
this process.

* PPO CartPole-v1 learns to a best ``episode_return_mean`` >= 100 within
  12 iterations, at the reference's configuration and bar
  (``tests/test_rllib.py:211-247``: one runner of 8 envs, fragments of 64,
  batch 2048, minibatch 256, 8 epochs, entropy 0.01, fcnet (64, 64),
  seed 0);
* the checkpoint round trip (``tests/test_rllib.py:250-267``): restored
  weights and optimizer state equal the saved ones, through ``save`` /
  ``restore``, ``from_checkpoint`` and the Trainable blobs;
* ``evaluate``'s greedy episodes;
* one iteration of the Atari-shaped configuration (ConvModule on uint8
  [84, 84, 4], ``raytpu/RandomImage-v0`` through the runners), of a
  recurrent one (LSTMModule on CartPole) and of two learners;
* the pixel envs make the reference's frames from the same seed;
* the entry points that waited for ROADMAP Queue A item 7b (multi-agent
  configs, the asynchronous sampling pipeline) now run: a gym id is
  refused as a multi-agent env, as in the reference, and the runners'
  ``sample_async`` / ``collect_ready`` hand back fragments.
"""

import gymnasium as gym
import numpy as np
import pytest

import ray_tpu.rllib.env.pixel_envs as jpix
import ray_tpu_torch.rllib.env.pixel_envs as ppix
from ray_tpu_torch.rllib import PPOConfig
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO

BAR, MAX_ITERS = 100.0, 12


def _cartpole_config():
    return (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=8, rollout_fragment_length=64)
        .training(lr=3e-4, train_batch_size=2048, minibatch_size=256, num_epochs=8,
                  entropy_coeff=0.01, model={"fcnet_hiddens": (64, 64)})
        .debugging(seed=0)
    )


@pytest.fixture(scope="module")
def cartpole():
    algo = _cartpole_config().build_algo(device="cpu")
    yield algo
    algo.stop()


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, list):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [np.asarray(tree)]


def _assert_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


def test_ppo_cartpole_learns(cartpole):
    best, results = -np.inf, []
    for _ in range(MAX_ITERS):
        result = cartpole.train()
        results.append(result)
        if not np.isnan(result["episode_return_mean"]):
            best = max(best, result["episode_return_mean"])
        if best >= BAR:
            break
    assert best >= BAR, f"PPO failed to learn CartPole: best={best}"
    last = results[-1]
    assert last["num_env_steps_sampled_lifetime"] == 2048 * len(results)
    assert last["learner/num_env_steps_trained"] == 2048
    for key in ("total_loss", "policy_loss", "vf_loss", "entropy", "kl"):
        assert np.isfinite(last[f"learner/{key}"]), key
    assert last["metrics"]["num_env_steps_sampled"] == 2048 * len(results)


def test_checkpoint_round_trip(cartpole, tmp_path):
    path = cartpole.save(str(tmp_path / "ckpt"))
    iteration = cartpole.iteration
    state = cartpole.learner_group.get_state()
    blob = cartpole.save_checkpoint()
    cartpole.train()
    moved = cartpole.learner_group.get_state()
    assert any(not np.array_equal(a, b) for a, b in zip(_leaves(state["params"]),
                                                         _leaves(moved["params"])))
    cartpole.restore(path)
    assert cartpole.iteration == iteration
    _assert_equal(cartpole.learner_group.get_state(), state)
    cartpole.train()
    cartpole.load_checkpoint(blob)
    assert cartpole.iteration == iteration
    _assert_equal(cartpole.learner_group.get_state(), state)
    restored = PPO.from_checkpoint(path, _cartpole_config(), device="cpu")
    try:
        assert restored.iteration == iteration
        _assert_equal(restored.learner_group.get_state(), state)
    finally:
        restored.stop()


def test_evaluate(cartpole):
    out = cartpole.evaluate()
    assert out["num_episodes"] == cartpole.config.evaluation_duration == 5
    # CartPole pays 1 a step, and an episode lasts 8 steps at the least.
    assert np.isfinite(out["episode_return_mean"]) and out["episode_return_mean"] >= 8


def test_multi_agent_and_impala_entry_points_wait_for_7b(cartpole):
    """Item 7b is ported: what raised NotImplementedError here runs."""
    config = PPOConfig().environment("CartPole-v1").multi_agent(policies={"p0", "p1"})
    with pytest.raises(ValueError, match="MultiAgentEnv class"):
        config.build_algo(device="cpu")
    group = cartpole.env_runner_group
    group.sample_async()
    ready = []
    while not ready:
        ready = group.collect_ready(timeout=60.0)
    assert all(len(b) == 8 * 64 for b in ready)
    group.sync_weights(cartpole.learner_group.get_weights())  # drains the resubmitted sample


def test_atari_shaped_iteration():
    algo = (
        PPOConfig()
        .environment("ray_tpu_torch.rllib.env.pixel_envs:raytpu/RandomImage-v0")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=16)
        .training(lr=3e-4, train_batch_size=32, minibatch_size=16, num_epochs=1)
        .debugging(seed=0)
        .build_algo(device="cpu")
    )
    try:
        assert type(algo.learner_group.local_learner.module).__name__ == "ConvModule"
        assert algo.observation_space.shape == (84, 84, 4)
        assert algo.observation_space.dtype == np.uint8
        result = algo.train()
        assert result["learner/num_env_steps_trained"] == 32
        assert np.isfinite(result["learner/total_loss"])
    finally:
        algo.stop()


def test_recurrent_iteration():
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=16)
        .training(train_batch_size=64, minibatch_size=32, num_epochs=1,
                  model={"use_lstm": True, "fcnet_hiddens": (16,), "lstm_cell_size": 16,
                         "max_seq_len": 16})
        .debugging(seed=0)
        .build_algo(device="cpu")
    )
    try:
        result = algo.train()
        assert result["learner/num_env_steps_trained"] == 64
        assert np.isfinite(result["learner/total_loss"])
        assert algo.evaluate()["num_episodes"] == 5
    finally:
        algo.stop()


def test_two_learners_iteration():
    """num_learners=2: the learners on a gang of two gloo processes; GAE's
    bootstrap values come from their weights, on the algorithm's device."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=4, rollout_fragment_length=16)
        .training(train_batch_size=64, minibatch_size=32, num_epochs=1,
                  model={"fcnet_hiddens": (16,)})
        .learners(num_learners=2)
        .debugging(seed=0)
        .build_algo(device="cpu")
    )
    try:
        assert algo.learner_group.local_learner is None
        before = algo.learner_group.get_weights()
        result = algo.train()
        assert result["learner/num_env_steps_trained"] == 64
        assert np.isnan(result["learner/total_loss"])  # the reference's DP report
        after = algo.learner_group.get_weights()
        assert all(not np.array_equal(a, b) for a, b in zip(_leaves(before), _leaves(after)))
        ranks = algo.learner_group._all("get_weights")
        _assert_equal(ranks[0], ranks[1])
    finally:
        algo.stop()


@pytest.mark.parametrize("name", ["RandomImageEnv", "MovingDotEnv"])
def test_pixel_envs_make_the_reference_frames(name):
    envs = [getattr(jpix, name)(), getattr(ppix, name)()]
    frames = [[env.reset(seed=3)[0]] for env in envs]
    for step in range(6):
        for env, out in zip(envs, frames):
            obs, reward, term, trunc, _ = env.step(step % env.action_space.n)
            out.append((obs, reward, term, trunc))
    for a, b in zip(*frames):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
        else:
            np.testing.assert_array_equal(a, b)
    assert envs[1].observation_space == envs[0].observation_space


def test_pixel_env_ids_resolve_by_module_prefix():
    # The id runner processes make: the module prefix imports the port's
    # pixel_envs there, which registers the ids.
    vec = gym.make_vec("ray_tpu_torch.rllib.env.pixel_envs:raytpu/RandomImage-v0", num_envs=2)
    try:
        obs, _ = vec.reset(seed=0)
        assert obs.shape == (2, 84, 84, 4) and obs.dtype == np.uint8
    finally:
        vec.close()
    assert "raytpu/MovingDot-v0" in gym.registry
