"""Wrappers of the hand-written CUDA 2×2 max pool (``csrc/pool.cu``).

Replaces ``keypoints_tpu/kernels/pool_pallas.py`` ``max_pool_2x2_pallas``
(K6) on NVIDIA Hopper: the forward kernel and the first-maximum backward
kernel, paired by :class:`MaxPool2x2` as the JAX package's ``custom_vjp``
pairs the Pallas kernels. The layout is NCHW, the port's (the Pallas kernel
is NHWC); the VGG trunk runs in NCHW, so one layout is enough. The kernels
come from the port's one kernel library (``kernels/_build.py``).

The plain PyTorch version is ``keypoints_tpu_torch.ops.pool.max_pool_2x2``;
``chip_smoke.py`` also times ``F.max_pool2d`` and its backward beside it as a
yardstick, which the port never calls.
"""

from __future__ import annotations

import ctypes

import torch

from keypoints_tpu_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: forward kernel launches so far; the wrapper adds one per launch, nowhere else
launches = 0
#: backward kernel launches so far
bwd_launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check(x: torch.Tensor, what: str) -> None:
    _build.require(x, what, tuple(DTYPES), 4)
    h, w = x.shape[2:]
    if h % 2 or w % 2:
        raise ValueError(f"{what} needs even H and W, got {h}x{w}")
    # the kernels load the two columns of a window row as one aligned word
    if x.data_ptr() % (2 * x.element_size()):
        raise ValueError(f"{what} needs a tensor aligned to two elements")


def max_pool_fwd_cuda(x: torch.Tensor) -> torch.Tensor:
    """Forward kernel: ``(N, C, H, W)`` contiguous f32 or bf16 CUDA, H and W
    even → ``(N, C, H/2, W/2)`` in ``x``'s dtype. Launches on the current
    stream and does not synchronise; carries no gradient (see
    :class:`MaxPool2x2`)."""
    global launches
    _check(x, "max_pool_fwd_cuda")
    n, c, h, w = x.shape
    out = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("kp_max_pool_fwd", _I, _L, _I, _I, _P, _P, _P)
    _build.launch(fn, x, f"max_pool_fwd ({n}x{c}x{h}x{w})", DTYPES[x.dtype],
                  n * c, h, w, x.data_ptr(), out.data_ptr())
    with _build.lock:
        launches += 1
    return out


def max_pool_bwd_cuda(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Backward kernel: ``x`` as for the forward and ``dL/dy`` ``(N, C, H/2,
    W/2)`` contiguous in ``x``'s dtype → ``dL/dx`` ``(N, C, H, W)``: each
    window's gradient at its first maximum (row-major), 0 elsewhere."""
    global bwd_launches
    _check(x, "max_pool_bwd_cuda x")
    _build.require(grad, "max_pool_bwd_cuda grad", (x.dtype,), 4)
    n, c, h, w = x.shape
    if tuple(grad.shape) != (n, c, h // 2, w // 2) or grad.device != x.device:
        raise ValueError(f"max_pool_bwd_cuda needs a {(n, c, h // 2, w // 2)} "
                         f"grad on {x.device}, got {tuple(grad.shape)} on "
                         f"{grad.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.entry("kp_max_pool_bwd", _I, _L, _I, _I, _P, _P, _P, _P)
    _build.launch(fn, x, f"max_pool_bwd ({n}x{c}x{h}x{w})", DTYPES[x.dtype],
                  n * c, h, w, x.data_ptr(), grad.data_ptr(), out.data_ptr())
    with _build.lock:
        bwd_launches += 1
    return out


class MaxPool2x2(torch.autograd.Function):
    """2×2/stride-2 max pool with the CUDA forward and the CUDA backward.

    Saves only the input: the backward kernel finds each window's first
    maximum again. The incoming gradient is cast to the input's dtype and
    made contiguous first.
    """

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return max_pool_fwd_cuda(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return max_pool_bwd_cuda(x, grad.to(x.dtype).contiguous())


def max_pool_2x2_cuda(x: torch.Tensor) -> torch.Tensor:
    """``(N, C, H, W) -> (N, C, H/2, W/2)`` through :class:`MaxPool2x2`,
    differentiable in ``x``."""
    return MaxPool2x2.apply(x)
