"""Wrappers of the hand-written CUDA Gaussian raster (``csrc/gaussian.cu``).

Replaces ``keypoints_tpu/kernels/gaussian_pallas.py`` ``gaussian_maps_pallas``
(K2) on NVIDIA Hopper: the forward raster and its hand-written backward.
:class:`GaussianMaps` is the ``torch.autograd.Function`` pairing the two, as
the JAX package's ``custom_vjp`` pairs the Pallas kernels. The kernels come
from the port's one kernel library (``kernels/_build.py``).

The plain PyTorch version is ``keypoints_tpu_torch.ops.gaussian``; the tests
and ``chip_smoke.py`` hold the kernels against it and its autograd.
"""

from __future__ import annotations

import ctypes

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import _build

#: forward kernel launches so far; the wrapper adds one per launch, nowhere else
launches = 0
#: backward kernel launches so far
bwd_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_sigma(sigma: float) -> None:
    if not sigma > 0:
        raise ValueError(f"sigma must be positive, got {sigma}")


def gaussian_fwd_cuda(keypoints: torch.Tensor, height: int, width: int,
                      sigma: float = 0.1,
                      align_corners: bool = DEFAULT_ALIGN_CORNERS
                      ) -> torch.Tensor:
    """Forward kernel: keypoints ``(N, 2)`` f32 CUDA → maps ``(N, H, W)`` f32."""
    global launches
    _build.require(keypoints, "gaussian_fwd_cuda", (torch.float32,), 2)
    if keypoints.shape[1] != 2 or height < 1 or width < 1:
        raise ValueError(f"gaussian_fwd_cuda needs (N, 2) keypoints and a "
                         f"positive size, got {tuple(keypoints.shape)} -> "
                         f"{height}x{width}")
    _check_sigma(sigma)
    n = keypoints.shape[0]
    out = torch.empty((n, height, width), dtype=torch.float32,
                      device=keypoints.device)
    if n == 0:
        return out
    fn = _build.entry("kp_gaussian_fwd", _I, _I, _I, _F, _I, _P, _P, _P)
    _build.launch(fn, keypoints, f"gaussian_fwd (N={n}, {height}x{width})",
                  n, int(height), int(width), float(sigma),
                  int(bool(align_corners)), keypoints.data_ptr(),
                  out.data_ptr())
    with _build.lock:
        launches += 1
    return out


def gaussian_bwd_cuda(keypoints: torch.Tensor, grad: torch.Tensor,
                      sigma: float = 0.1,
                      align_corners: bool = DEFAULT_ALIGN_CORNERS
                      ) -> torch.Tensor:
    """Backward kernel: keypoints ``(N, 2)`` and ``dL/dmaps`` ``(N, H, W)``,
    contiguous f32 CUDA → ``dL/dkeypoints`` ``(N, 2)`` f32."""
    global bwd_launches
    _build.require(keypoints, "gaussian_bwd_cuda keypoints",
                   (torch.float32,), 2)
    _build.require(grad, "gaussian_bwd_cuda grad", (torch.float32,), 3)
    n, h, w = grad.shape
    if tuple(keypoints.shape) != (n, 2) or grad.device != keypoints.device:
        raise ValueError(f"gaussian_bwd_cuda keypoints must be ({n}, 2) on "
                         f"{grad.device}, got {tuple(keypoints.shape)} on "
                         f"{keypoints.device}")
    _check_sigma(sigma)
    out = torch.empty((n, 2), dtype=torch.float32, device=grad.device)
    if n == 0:
        return out
    fn = _build.entry("kp_gaussian_bwd", _I, _I, _I, _F, _I, _P, _P, _P, _P)
    _build.launch(fn, grad, f"gaussian_bwd (N={n}, {h}x{w})", n, h, w,
                  float(sigma), int(bool(align_corners)),
                  keypoints.data_ptr(), grad.data_ptr(), out.data_ptr())
    with _build.lock:
        bwd_launches += 1
    return out


class GaussianMaps(torch.autograd.Function):
    """Gaussian raster with the CUDA forward and the CUDA backward.

    Saves only the keypoints; the backward recomputes the maps in the
    kernel. The incoming gradient is made f32 and contiguous first (the
    decoder hands back a bf16-cast, channel-sliced gradient).
    """

    @staticmethod
    def forward(ctx, keypoints, height, width, sigma, align_corners):
        ctx.save_for_backward(keypoints)
        ctx.args = (sigma, align_corners)
        return gaussian_fwd_cuda(keypoints, height, width, sigma,
                                 align_corners)

    @staticmethod
    def backward(ctx, grad):
        (keypoints,) = ctx.saved_tensors
        dkp = gaussian_bwd_cuda(keypoints, grad.float().contiguous(),
                                *ctx.args)
        return dkp, None, None, None, None


def gaussian_maps_cuda(keypoints: torch.Tensor, height: int, width: int,
                       sigma: float = 0.1,
                       align_corners: bool = DEFAULT_ALIGN_CORNERS
                       ) -> torch.Tensor:
    """``(B, K, 2)`` keypoints → ``(B, K, H, W)`` maps through
    :class:`GaussianMaps`, differentiable in the keypoints."""
    b, k, _ = keypoints.shape
    flat = keypoints.reshape(b * k, 2).float().contiguous()
    maps = GaussianMaps.apply(flat, int(height), int(width), float(sigma),
                              bool(align_corners))
    return maps.reshape(b, k, height, width)
