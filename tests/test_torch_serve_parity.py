"""The port's serve plane on its runtime core against the reference's, on
one scripted scenario, and the tiny transformer served by each.

* ``tests/_torch_serve_scenario.py`` runs, through ``ray_tpu`` and through
  ``ray_tpu_torch``, each in its own process (at once): ``init``,
  ``serve.run`` of a ``@batch`` deployment and its ``user_config``
  reconfigure, calls through a handle and through the HTTP proxy actor,
  ``serve.status()`` through RUNNING, a replica killed with the package's
  ``kill`` and replaced, an expired deadline (``DeadlineExceededError``), an
  admission shed (``RequestShedError``) and the proxy's 503, ``delete``, and
  the names of the serve series that ``collect_prometheus_text()`` renders.
  The two records of outcomes are equal.
* The slice as a whole: the tiny transformer behind a deployment in each
  package on the CPU, the port's from parameters carried from JAX's
  ``init_params`` by ``models/convert.py``: the logits fetched through the
  port's handle match the JAX forward within the f32 tolerance of ROADMAP's
  parity rules, as the reference's deployment's do.
"""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import _torch_serve_apps as apps
import ray_tpu_torch as rt
from ray_tpu.models import transformer as jt
from ray_tpu_torch import serve

ROOT = Path(__file__).resolve().parent.parent
F32_FORWARD_TOL = 2e-5


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _scenario(package: str) -> dict:
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_serve_scenario.py"), package,
         str(_free_port())],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_scripted_scenario_has_the_references_outcomes():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        reference, port = pool.map(_scenario, ["ray_tpu", "ray_tpu_torch"])
    assert port == reference
    # And the outcomes are the ones the API promises.
    assert reference["batched"] == [2 * i for i in range(8)] and reference["reconfigured"]
    assert reference["http"] == [200, "15"] and reference["replaced"]["answer"] == 12
    assert reference["deadline"] == "DeadlineExceededError"
    assert reference["shed"] == "RequestShedError" and reference["shed_http"] == 503
    assert reference["deleted"] and reference["deleted_http"] == 404
    assert {"ray_tpu_rt_serve_requests_total", "ray_tpu_rt_serve_shed_total",
            "ray_tpu_rt_serve_deadline_exceeded_total"} <= set(reference["series"])


def test_the_tiny_transformer_behind_a_deployment_matches_jax(ray_start_shared):
    from ray_tpu import serve as ref_serve

    config = jt.TransformerConfig.tiny()
    params = jax.tree.map(np.asarray, jt.init_params(config, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, config.vocab_size, (2, 32)).astype(np.int32)
    want = np.asarray(jt.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(tokens), config))

    @ref_serve.deployment
    class RefTinyLogits:
        def __init__(self, numpy_params):
            import jax
            import jax.numpy as jnp

            from ray_tpu.models.transformer import TransformerConfig, forward

            self.config = TransformerConfig.tiny()
            self.params = jax.tree.map(jnp.asarray, numpy_params)
            self.forward = forward

        def __call__(self, tokens):
            import jax.numpy as jnp
            import numpy as np

            return np.asarray(self.forward(self.params, jnp.asarray(tokens), self.config))

    rt.init(num_cpus=4)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ref_handle = pool.submit(ref_serve.run, RefTinyLogits.bind(params), name="tiny",
                                     route_prefix="/tiny")
            handle = serve.run(apps.TinyLogits.bind(params), name="tiny", route_prefix="/tiny")
            ref_handle = ref_handle.result(timeout=240)
        ours = handle.remote(tokens).result(timeout=120)
        theirs = ref_handle.remote(tokens).result(timeout=120)
    finally:
        serve.shutdown()
        rt.shutdown()
        ref_serve.shutdown()
    assert ours.dtype == np.float32 and ours.shape == (2, 32, config.vocab_size)
    assert float(np.max(np.abs(ours - want))) < F32_FORWARD_TOL
    assert float(np.max(np.abs(theirs - want))) < F32_FORWARD_TOL
