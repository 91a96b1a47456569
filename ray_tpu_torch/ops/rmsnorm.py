"""RMSNorm: a hand-written CUDA kernel (``csrc/rmsnorm.cu``) and its plain
version, differentiable through ``_RMSNorm``.

``rmsnorm`` launches the kernel for CUDA tensors and uses the plain
``rmsnorm_reference`` only for tensors on the CPU. It takes any row count;
on the card, ``dim`` must be a multiple of 8 (the kernel moves 8 elements
per 16-byte access).

The backward is plain PyTorch, as the JAX package leaves it to XLA (it has
no backward kernel for the norm). Like the JAX model's ``_rmsnorm_ckpt``
(``jax.checkpoint`` of the reference) it saves only x and the weight and
recomputes the f32 normalisation from x.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w, f32 math, cast to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _rmsnorm_forward(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps=eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, weight on {weight.device}")
    if x.dtype not in _KERNEL_DTYPES or weight.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm kernel takes x and weight both f32 or both bf16, got {x.dtype}, {weight.dtype}"
        )
    dim = x.shape[-1]
    if weight.shape != (dim,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} for dim {dim}")
    if dim % 8:
        raise ValueError(f"rmsnorm kernel takes a dim that is a multiple of 8, got {dim}")
    x = _build.contiguous_aligned(x)
    weight = _build.contiguous_aligned(weight)
    y = torch.empty_like(x)
    rows = x.numel() // dim if dim else 0
    if rows == 0:
        return y
    _build.launch(
        "rt_rmsnorm", x.device,
        x.data_ptr(), weight.data_ptr(), y.data_ptr(), rows, dim,
        int(x.dtype == torch.bfloat16), float(eps),
    )
    rmsnorm.launches += 1
    return y


def _rmsnorm_backward(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw summed over rows in f32 and cast to w's dtype),
    from x recomputed in f32: with r = rsqrt(mean(x^2) + eps), n = x * r and
    g = dy * w, dx = r * (g - n * mean(g * n)) and dw = sum(dy * n)."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    n = xf * r
    dyf = dy.float()
    g = dyf * weight.float()
    dx = r * (g - n * torch.mean(g * n, dim=-1, keepdim=True))
    dw = (dyf * n).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rmsnorm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = _rmsnorm_backward(x, weight, dy, ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: [..., dim]; weight: [dim]. Same function as ``rmsnorm_reference``,
    differentiable in x and weight."""
    return _RMSNorm.apply(x, weight, float(eps))


# Kernel launches since the count was last set to 0.
rmsnorm.launches = 0
