"""RMSNorm: hand-written CUDA kernels for both directions (``csrc/rmsnorm.cu``)
and their plain versions, differentiable through ``_RMSNorm``.

``rmsnorm`` launches the forward kernel for CUDA tensors and uses the plain
``rmsnorm_reference`` only for tensors on the CPU; ``rmsnorm_backward``
launches the backward kernel for CUDA tensors and uses the plain
``_rmsnorm_backward`` only for tensors on the CPU. Both take any row count
and any dim, x in f32, bf16 or f16 and the weight in any of those three,
as the JAX reference does: the math is f32, y and dx take x's dtype and dw
the weight's. The kernels move 16-byte pieces where x and the weight share
a dtype and the dim is a whole number of pieces (every model dim), and one
element at a time otherwise.

Like the JAX model's ``_rmsnorm_ckpt`` (``jax.checkpoint`` of the
reference), ``_RMSNorm`` saves only x and the weight, and the backward
recomputes the f32 normalisation from x. Where autograd has nothing to
record (grad mode off, or no input that requires a gradient: serving and
decode), ``rmsnorm`` calls the forward without the autograd Function.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch import _build


def rmsnorm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w, f32 math, cast to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _check_kernel_inputs(
    what: str, x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor | None = None
) -> None:
    """Raises unless the kernels take these tensors (dy, where given, shaped
    and typed like x). This runs at every launch, so the common path is one
    test of cheap attributes (``is_cuda`` and device indices, not device
    objects), and the reason is worked out only when it fails."""
    index, dtype, dim = x.get_device(), x.dtype, x.shape[-1]
    if (not x.is_cuda or not weight.is_cuda or weight.get_device() != index
            or dtype not in _build.DTYPE_CODES or weight.dtype not in _build.DTYPE_CODES
            or weight.shape != (dim,)
            or (dy is not None
                and (not dy.is_cuda or dy.get_device() != index or dy.dtype != dtype
                     or dy.shape != x.shape))):
        _reject(what, x, weight, dy)


def _reject(what: str, x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor | None) -> None:
    if x.device.type != "cuda" or weight.device != x.device or (
            dy is not None and dy.device != x.device):
        raise ValueError(f"{what}: x on {x.device}, weight on {weight.device}")
    if x.dtype not in _build.DTYPE_CODES or weight.dtype not in _build.DTYPE_CODES:
        raise TypeError(
            f"{what} kernel takes x and weight in f32, bf16 or f16, got {x.dtype}, {weight.dtype}"
        )
    dim = x.shape[-1]
    if weight.shape != (dim,):
        raise ValueError(f"{what}: weight {tuple(weight.shape)} for dim {dim}")
    raise ValueError(f"{what}: dy {tuple(dy.shape)} {dy.dtype} beside x {tuple(x.shape)} {x.dtype}")


def _rmsnorm_forward(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.is_cuda and x.device.type == "cpu" and weight.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps=eps)
    _check_kernel_inputs("rmsnorm", x, weight)
    x, weight = _build.contiguous_aligned(x), _build.contiguous_aligned(weight)
    y = torch.empty_like(x)
    dim = x.shape[-1]
    rows = x.numel() // dim if dim else 0
    if rows:
        _build.launch(
            "rt_rmsnorm", x.device,
            x.data_ptr(), weight.data_ptr(), y.data_ptr(), rows, dim,
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[weight.dtype], eps,
        )
        with _build.COUNT_LOCK:
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


def rmsnorm_backward(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``rmsnorm(x, weight, eps)`` for the output gradient dy,
    the same function as ``_rmsnorm_backward``. On the card dw is summed in
    a fixed order, so it is the same on every run."""
    if not x.is_cuda and all(t.device.type == "cpu" for t in (x, weight, dy)):
        return _rmsnorm_backward(x, weight, dy, eps)
    _check_kernel_inputs("rmsnorm_backward", x, weight, dy)
    x, weight, dy = (_build.contiguous_aligned(t) for t in (x, weight, dy))
    dx = torch.empty_like(x)
    dim = x.shape[-1]
    rows = x.numel() // dim if dim else 0
    if rows == 0:
        return dx, torch.zeros_like(weight)
    dw = torch.empty_like(weight)
    parts = ctypes.c_int(0)
    head = (x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr())
    tail = (ctypes.byref(parts), rows, dim, _build.DTYPE_CODES[x.dtype],
            _build.DTYPE_CODES[weight.dtype], float(eps))
    # With no scratch the entry point only says how many f32 rows of
    # per-block dw sums the launch needs.
    _build.launch("rt_rmsnorm_bwd", x.device, *head, None, *tail)
    partial = torch.empty(parts.value, dim, dtype=torch.float32, device=x.device)
    _build.launch("rt_rmsnorm_bwd", x.device, *head, partial.data_ptr(), *tail)
    with _build.COUNT_LOCK:
        rmsnorm_backward.launches += 1
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rmsnorm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        # One kernel writes dx and dw; only those autograd asks for are
        # handed back (a frozen weight takes none, LoRA's norms).
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_backward(x, weight, dy, ctx.eps)
        need_x, need_w = ctx.needs_input_grad[:2]
        return dx if need_x else None, dw if need_w else None, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: [..., dim]; weight: [dim]. Same function as ``rmsnorm_reference``,
    differentiable in x and weight."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, float(eps))
    return _rmsnorm_forward(x, weight, float(eps))


# Kernel launches since the counts were last set to 0.
rmsnorm.launches = 0
rmsnorm_backward.launches = 0
