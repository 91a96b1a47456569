"""The port's runtime core against the reference's, on one scripted
scenario and on the tiny transformer behind a runtime actor.

* ``tests/_torch_core_scenario.py`` runs tasks, actors, errors, ``wait``
  order, named actors and the resource tables (the reference's TPU key and
  the port's GPU key written as one) through ``ray_tpu`` and through
  ``ray_tpu_torch``, each in its own process, one after the other. The two
  records of outcomes are equal.
* The slice as a whole: an actor of the port's runtime, on the CPU
  (``device="cpu"``), runs the tiny transformer's forward on parameters
  carried from JAX's ``init_params`` by ``models/convert.py``; its logits,
  fetched through ``get``, match the JAX model's forward within the f32
  tolerance of ROADMAP's parity rules.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import transformer as jt

ROOT = Path(__file__).resolve().parent.parent
F32_FORWARD_TOL = 2e-5


def _scenario(package: str) -> dict:
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_core_scenario.py"), package],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_scripted_scenario_has_the_references_outcomes():
    reference = _scenario("ray_tpu")
    port = _scenario("ray_tpu_torch")
    assert port == reference
    # And the outcomes are the ones the API promises.
    assert reference["wait_first"] == ["fast"] and reference["after_kill"] == "ActorDiedError"
    assert reference["total"] == {"CPU": 4.0, "ACCEL": 2.0} and reference["accel_back"] == 2.0
    # ROADMAP Queue C item 25, a fault of the reference that the port
    # follows: a ref made only for an actor constructor's argument is freed
    # before the actor reads it, and the creation never completes.
    assert reference["temporary_constructor_ref"] == "GetTimeoutError"
    assert reference["held_constructor_ref"] == 1000


@rt.remote
class TinyModel:
    def __init__(self, params):
        from ray_tpu_torch.models import transformer as pt
        from ray_tpu_torch.models.convert import params_from_numpy

        self.pt = pt
        self.config = pt.TransformerConfig.tiny()
        self.params = params_from_numpy(params, device="cpu")

    def forward(self, tokens):
        with torch.no_grad():
            return self.pt.forward(self.params, torch.from_numpy(np.asarray(tokens)),
                                   self.config)


@pytest.fixture(scope="module")
def cluster():
    assert not rt.is_initialized()
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_the_tiny_transformer_behind_an_actor_matches_jax(cluster):
    config = jt.TransformerConfig.tiny()
    params = jt.init_params(config, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, config.vocab_size, (2, 32)).astype(np.int32)
    want = np.asarray(jt.forward(params, jnp.asarray(tokens), config))
    # Held in a name: a ref made only for a constructor's argument is freed
    # before the actor reads it, in both packages (ROADMAP Queue C item 25).
    params_ref = rt.put(jax.tree.map(np.asarray, params))
    model = TinyModel.remote(params_ref)
    logits = rt.get(model.forward.remote(rt.put(tokens)), timeout=120)
    assert isinstance(logits, torch.Tensor) and logits.dtype == torch.float32
    assert logits.shape == (2, 32, config.vocab_size)
    assert float(np.max(np.abs(logits.numpy() - want))) < F32_FORWARD_TOL
