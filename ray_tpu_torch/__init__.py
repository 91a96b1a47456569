"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's accelerator path.

The port runs on an NVIDIA Hopper card (H100, ``sm_90a``). Its kernels are
written by hand in CUDA C++ (``ops/csrc/``) and built at first use; each has
a plain PyTorch version beside it that serves CPU tensors only.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
With no card and no explicit ``device="cpu"`` it raises ``RuntimeError``: the
port never runs on the CPU without being asked to.

``cluster_resources()`` and ``available_resources()`` read this host's
resource ledger (``_private.resources``) under the reference's names.

Importing the package imports no torch: a data worker process, which
unpickles the package's functions by name, starts without it.
"""

from __future__ import annotations

from ray_tpu_torch._private.resources import available_resources, cluster_resources

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default; raises when a CUDA device is asked for and absent."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device
