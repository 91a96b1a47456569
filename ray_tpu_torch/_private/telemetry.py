"""Device-memory probe for node telemetry.

The counterpart of ray_tpu's ``NodeAgent._hbm_stats``
(``_private/node_agent.py``), which sums ``memory_stats()`` over the TPU
devices of a process that already imported jax. Its consumer, the node
agent's telemetry buffer, is runtime and not ported.
"""

from __future__ import annotations


def hbm_stats(device=None) -> dict:
    """``{"hbm_used", "hbm_total"}`` in bytes from ``torch.cuda.mem_get_info``
    of the process's card: ``device``, or the current device (a gang member
    drives one card, and probing the others would open a context on each).
    Used is what the whole card has in use, every process on it included.
    ``{}`` when the process has not initialised CUDA: telemetry never forces
    a CUDA init, as the reference's agent never imports jax itself."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    index = torch.cuda.current_device() if device is None else torch.device(device).index or 0
    free, total = torch.cuda.mem_get_info(index)
    if not total:
        return {}
    return {"hbm_used": int(total - free), "hbm_total": int(total)}
