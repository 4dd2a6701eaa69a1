"""Wrappers of the hand-written CUDA fused bottleneck (``csrc/fused_bottleneck.cu``).

Replaces ``keypoints_tpu/kernels/fused_bottleneck.py``
``softargmax_raster_fused`` (K3) on NVIDIA Hopper: heatmaps → keypoints and
their Gaussian maps in one kernel, both soft-argmax variants. The kernel
comes from the port's one kernel library (``kernels/_build.py``).

:class:`SoftargmaxRasterFused` carries the gradient as the JAX package's
``custom_vjp`` does (``_fused_bwd``): the raster's backward kernel (K2
backward, ``gaussian_cuda.gaussian_bwd_cuda``) turns ``dL/dmaps`` into a
keypoint gradient, the direct ``dL/dkeypoints`` is added to it, and the
soft-argmax backward kernel (K1b, ``spatial_softmax_cuda.
spatial_softmax_bwd_cuda``) turns the sum into ``dL/dheatmaps``. No backward
kernel of its own.

The plain PyTorch version is ``keypoints_tpu_torch.ops.fused_bottleneck``;
the tests and ``chip_smoke.py`` hold the kernel against it and its
autograd. Nothing on the CUDA path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import _build
from keypoints_tpu_torch.kernels.gaussian_cuda import (MAX_TABLE,
                                                       check_sigma,
                                                       gaussian_bwd_cuda)
from keypoints_tpu_torch.kernels.spatial_softmax_cuda import (
    VARIANTS, WARP_MAX_SIDE, check_heatmaps, spatial_softmax_bwd_cuda)

#: floats of static shared memory the block path (H or W above 64) keeps
#: for its reductions (``csrc/fused_bottleneck.cu`` kBlockStatic)
BLOCK_STATIC = 4 * 256 + 3 * 8

#: kernel launches so far; the wrapper adds one per launch, nowhere else
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def table_floats(height: int, width: int, out_height: int, out_width: int,
                 variant: str) -> int:
    """Floats of shared memory a block of the kernel needs for one
    ``height x width`` heatmap and an ``out_height x out_width`` map: the
    output's coordinate table (Ho + Wo), and on the block path its
    reduction scratch and, marginal, the column and row sums (H + W). At
    most :data:`gaussian_cuda.MAX_TABLE` (227 KB), the raster's limit."""
    floats = out_height + out_width
    if max(height, width) > WARP_MAX_SIDE:
        floats += BLOCK_STATIC + (height + width if variant == "marginal"
                                  else 0)
    return floats


def softargmax_raster_cuda(heatmaps: torch.Tensor, out_height: int,
                           out_width: int, temperature: float = 1.0,
                           sigma: float = 0.1,
                           align_corners: bool = DEFAULT_ALIGN_CORNERS,
                           variant: str = "joint"
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: ``(B, K, H, W)`` f32 CUDA heatmaps → keypoints ``(B, K,
    2)`` ``(x, y)`` and maps ``(B, K, Ho, Wo)``, both f32.

    Launches on the current stream of the tensor's device and does not
    synchronise. Heatmaps of up to 64 a side take a warp per heatmap
    (``csrc/fused_bottleneck.cu`` kFusedWarps a block), larger ones a
    block; each writes its map in float4 runs of 4 pixels where Wo % 4 ==
    0, else pixel by pixel. Raises on anything the kernel does not take:
    what ``spatial_softmax_cuda.check_heatmaps`` rejects, sigma not
    positive, an output side below 1, or a block's shared memory
    (:func:`table_floats`) above :data:`gaussian_cuda.MAX_TABLE` floats: up
    to 64 a side, Ho + Wo up to 58,112, the raster backward's own limit.
    The outputs carry no gradient: :class:`SoftargmaxRasterFused` does.
    """
    check_heatmaps(heatmaps, variant, "softargmax_raster_cuda")
    check_sigma(sigma)
    ho, wo = int(out_height), int(out_width)
    b, k, h, w = heatmaps.shape
    if ho < 1 or wo < 1 or table_floats(h, w, ho, wo, variant) > MAX_TABLE:
        raise ValueError(f"softargmax_raster_cuda needs an output size "
                         f"with Ho, Wo >= 1 and at most {MAX_TABLE} floats "
                         f"of shared memory a block, got {h}x{w} -> "
                         f"{ho}x{wo} ({variant})")
    kp = torch.empty((b, k, 2), dtype=torch.float32, device=heatmaps.device)
    maps = torch.empty((b, k, ho, wo), dtype=torch.float32,
                       device=heatmaps.device)
    if b * k:
        _launch(heatmaps, kp, maps, temperature, sigma, align_corners,
                variant)
    return kp, maps


def _launch(heatmaps: torch.Tensor, kp: torch.Tensor, maps: torch.Tensor,
            temperature: float, sigma: float, align_corners: bool,
            variant: str) -> None:
    """The kernel into ``kp`` and ``maps`` (contiguous f32 views, ``maps``
    at any 4-byte offset: the kernel stores float4 runs only where the maps
    are 16-byte aligned), on checked heatmaps; counted."""
    global launches
    b, k, h, w = heatmaps.shape
    ho, wo = maps.shape[-2:]
    fn = _build.entry("kp_softargmax_raster_fwd", _I, _I, _I, _I, _I, _I, _F,
                      _F, _I, _P, _P, _P, _P)
    _build.launch(fn, heatmaps, f"softargmax_raster_fwd (N={b * k}, {h}x{w} "
                  f"-> {ho}x{wo}, {variant})", VARIANTS[variant], b * k, h, w,
                  ho, wo, 1.0 / float(temperature), float(sigma),
                  int(bool(align_corners)), heatmaps.data_ptr(),
                  kp.data_ptr(), maps.data_ptr())
    with _build.lock:
        launches += 1


class SoftargmaxRasterFused(torch.autograd.Function):
    """The fused forward kernel; the backward composes the raster's and the
    soft-argmax's backward kernels (``fused_bottleneck.py:84-115``).

    Saves the heatmaps and the keypoints; the backward kernels recompute the
    maps and the softmax from them. The incoming map gradient is made f32
    and contiguous first.
    """

    @staticmethod
    def forward(ctx, heatmaps, out_height, out_width, temperature, sigma,
                align_corners, variant):
        kp, maps = softargmax_raster_cuda(heatmaps, out_height, out_width,
                                          temperature, sigma, align_corners,
                                          variant)
        ctx.save_for_backward(heatmaps, kp)
        ctx.args = (temperature, sigma, align_corners, variant)
        return kp, maps

    @staticmethod
    def backward(ctx, g_kp, g_maps):
        heatmaps, kp = ctx.saved_tensors
        temperature, sigma, align_corners, variant = ctx.args
        b, k, ho, wo = g_maps.shape
        dkp = gaussian_bwd_cuda(kp.reshape(b * k, 2),
                                g_maps.float().reshape(b * k, ho, wo)
                                .contiguous(), sigma, align_corners)
        total = (g_kp.float() + dkp.reshape(b, k, 2)).contiguous()
        dh = spatial_softmax_bwd_cuda(heatmaps, kp, total, temperature,
                                      variant, align_corners)
        return dh, None, None, None, None, None, None


def softargmax_raster_autograd(heatmaps: torch.Tensor, out_height: int,
                               out_width: int, temperature: float = 1.0,
                               sigma: float = 0.1,
                               align_corners: bool = DEFAULT_ALIGN_CORNERS,
                               variant: str = "joint"
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """:class:`SoftargmaxRasterFused` applied: the keypoints and maps carry
    a ``grad_fn`` whenever ``heatmaps`` requires grad."""
    return SoftargmaxRasterFused.apply(heatmaps, int(out_height),
                                       int(out_width), float(temperature),
                                       float(sigma), bool(align_corners),
                                       variant)
