"""Helpers the port's RLlib parity tests share: errors over trees of the
reference's layout, the port's gradients as such a tree, and spaces."""

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu_torch.models.convert import _map, rl_params_from_numpy, rl_params_to_numpy
from ray_tpu_torch.rllib.core import learner as plearner

# ROADMAP's parity bounds for f32: losses 2e-5, gradients and parameters
# after updates 2e-4, as max |port - JAX| over max(1, max |JAX|).
F32_TOL = 2e-5
PARAM_TOL = 2e-4
CARTPOLE = (gym.spaces.Box(-1, 1, (4,), np.float32), gym.spaces.Discrete(2))
PIXELS = (gym.spaces.Box(0, 255, (32, 32, 1), np.uint8), gym.spaces.Discrete(2))
PENDULUM = (gym.spaces.Box(-8, 8, (3,), np.float32),
            gym.spaces.Box(-2.0, 2.0, (1,), np.float32))


def err(port, ref) -> float:
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(port - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def tree_err(port_tree, ref_tree) -> dict:
    """{path: error} over the leaves of two numpy trees of the reference's
    layout, matched by key path."""
    port = dict(jax.tree_util.tree_flatten_with_path(port_tree)[0])
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert len(port) == len(ref)
    return {jax.tree_util.keystr(path): err(port[path], leaf) for path, leaf in ref}


def to_port(tree) -> dict:
    """A tree of the reference's (jax arrays) -> the port's, f32 on the CPU."""
    return rl_params_from_numpy(jax.device_get(tree), device="cpu")


def to_ref(tree) -> dict:
    """A copy of the port's tree (tensors or numpy) in the reference's layout."""
    copy = _map(lambda t, _: np.array(t.detach().cpu() if isinstance(t, torch.Tensor) else t),
                tree)
    return rl_params_to_numpy(plearner._tensors(copy, "cpu"))


def fill(params, values) -> dict:
    """``params``' structure with its leaves, in ``named_leaves`` order,
    replaced by ``values`` (a gradient list)."""
    values = iter(values)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return next(values)

    return walk(params)


def port_grads(learner, batch) -> dict:
    """The port learner's gradient on ``batch``, in the reference's layout."""
    return to_ref(fill(learner.params, learner.compute_gradients(batch)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test runs its learner on one torch thread. The nets are small
    (MLPs of 16-64 units), where more threads only add synchronisation, and
    tier-1 runs six test processes beside the runner gangs' processes: with
    torch's default of a thread a core the learning tests ran 20-50x slower
    under that load than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
