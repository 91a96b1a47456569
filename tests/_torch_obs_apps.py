"""Functions that run in spawned processes for ``tests/test_torch_observability.py``
(gloo ranks through ``tests/_torch_ranks.py``, gang members). Nothing of JAX
or of the JAX package is imported here: the children import this module by
name."""

import numpy as np


def traced_collective_rank(rank, session_dir):
    """One gloo rank with tracing on: three allreduces and an allgather on a
    ring group, then one allreduce on a hier group (whose ring tier must not
    record a span of its own). Returns this rank's flight records of the
    user-visible ops and the ring's wire bytes."""
    from ray_tpu_torch._private import config
    from ray_tpu_torch.util import collective, tracing
    from ray_tpu_torch.util.collective import flight

    config.global_config().tracing_enabled = True
    tracing.configure(session_dir)
    collective.init_collective_group(2, rank, backend="ring", group_name="obs_ring")
    collective.init_collective_group(2, rank, backend="hier", group_name="obs_hier")
    try:
        ring = collective.get_group("obs_ring")
        for _ in range(3):
            ring.allreduce(np.ones(16, np.float32))
        ring.allgather(np.arange(8, dtype=np.float32) + rank)
        collective.get_group("obs_hier").allreduce(np.ones(1000, np.float32))
        records = [{k: r[k] for k in ("kind", "seq", "channel", "trace_id", "group")}
                   for r in flight.snapshot(4096) if r["kind"] in ("allreduce", "allgather")]
        wire = dict(ring.wire_stats)
    finally:
        collective.destroy_collective_group("obs_ring")
        collective.destroy_collective_group("obs_hier")
    tracing.flush()
    return records, wire


def ambient_trace(ctx):
    """The span context a gang member's function runs under."""
    from ray_tpu_torch.util import tracing

    return {"inject": tracing.inject(), "rank": ctx.rank}
