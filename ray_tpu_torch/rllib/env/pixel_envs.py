"""Pixel test/benchmark environments for the vision (conv) stack.

Role-equivalent of the reference's Atari benchmark harness
(rllib/tuned_examples/ppo/atari_ppo.py + the ALE envs it wraps): ALE ROMs
do not exist in this image, so the same two roles are covered by
in-process envs with the exact Atari observation contract
(uint8 [84, 84, 4] frame-stacked images, Discrete(6)):

  * ``raytpu/RandomImage-v0`` — throughput: pre-generated random frames,
    zero game logic, so a benchmark measures the rollout/learner
    machinery and the conv net, not a Python game loop.
  * ``raytpu/MovingDot-v0`` — learning: a bright dot sits in the left or
    right half of the frame; matching action earns +1. A conv policy
    must actually read pixels to beat the 0.5-per-step chance baseline,
    and can reach ~1/step quickly (the --as-test threshold role).

Importing this module registers both ids with gymnasium, each only if
no one has: a copy of ray_tpu's ``rllib/env/pixel_envs.py``, whose envs
make the same frames from the same seed, so whichever package registers
an id first serves both. A runner process makes them by
``"ray_tpu_torch.rllib.env.pixel_envs:raytpu/RandomImage-v0"``, which
imports this module there first.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np


class RandomImageEnv(gym.Env):
    """Atari-shaped observations with no game logic (throughput bench)."""

    metadata: dict = {"render_modes": []}

    def __init__(
        self,
        height: int = 84,
        width: int = 84,
        channels: int = 4,
        num_actions: int = 6,
        episode_len: int = 128,
        frame_bank: int = 32,
    ):
        self.observation_space = gym.spaces.Box(
            0, 255, shape=(height, width, channels), dtype=np.uint8
        )
        self.action_space = gym.spaces.Discrete(num_actions)
        self.episode_len = episode_len
        # Pre-generated frames: per-step obs is an index into this bank,
        # so stepping costs no RNG fill of a 28 KiB array.
        rng = np.random.default_rng(0)
        self._bank = rng.integers(
            0, 256, size=(frame_bank, height, width, channels), dtype=np.uint8
        )
        self._t = 0
        self._i = 0

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._i = (self._i + 1) % len(self._bank)
        return self._bank[self._i], {}

    def step(self, action):
        self._t += 1
        self._i = (self._i + 1) % len(self._bank)
        terminated = self._t >= self.episode_len
        return self._bank[self._i], 1.0, terminated, False, {}


class MovingDotEnv(gym.Env):
    """Trivially learnable pixel task: act toward the bright half."""

    metadata: dict = {"render_modes": []}

    def __init__(
        self, size: int = 32, channels: int = 1, episode_len: int = 32
    ):
        self.size = size
        self.episode_len = episode_len
        self.observation_space = gym.spaces.Box(
            0, 255, shape=(size, size, channels), dtype=np.uint8
        )
        self.action_space = gym.spaces.Discrete(2)
        self._t = 0
        self._side = 0

    def _obs(self) -> np.ndarray:
        obs = np.zeros(self.observation_space.shape, dtype=np.uint8)
        half = self.size // 2
        # a filled bright square in the chosen half (easy conv feature)
        r = self.np_random.integers(4, self.size - 8)
        c_base = 4 if self._side == 0 else half + 4
        c = c_base + int(self.np_random.integers(0, half - 12)) if half > 12 \
            else c_base
        obs[r : r + 6, c : c + 6, :] = 255
        return obs

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._side = int(self.np_random.integers(0, 2))
        return self._obs(), {}

    def step(self, action):
        reward = 1.0 if int(action) == self._side else 0.0
        self._t += 1
        self._side = int(self.np_random.integers(0, 2))
        terminated = self._t >= self.episode_len
        return self._obs(), reward, terminated, False, {}


def _register() -> None:
    for env_id, entry in (
        ("raytpu/RandomImage-v0", RandomImageEnv),
        ("raytpu/MovingDot-v0", MovingDotEnv),
    ):
        if env_id not in gym.registry:
            gym.register(id=env_id, entry_point=f"{__name__}:{entry.__name__}",
                         disable_env_checker=True)


_register()
