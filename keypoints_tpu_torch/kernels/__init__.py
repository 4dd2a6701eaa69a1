"""Hand-written CUDA kernels and their dispatchers.

A CUDA tensor goes to the kernel, a CPU tensor to the kernel's plain PyTorch
version (``keypoints_tpu_torch.ops``), and any other device raises. There is
no switch that forces the plain path on CUDA and no fallback when a launch
fails. The kernel modules (``spatial_softmax_cuda``, ``gaussian_cuda``,
``fused_bottleneck_cuda``, ``warp_cuda``, ``pool_cuda``,
``group_norm_cuda``: wrappers, autograd Functions and launch counts) are
submodules of this package; ``_build`` builds the one library they share.
The banded warps K7 and K8 (``experimental`` and ``experimental_cuda``)
are submodules too, outside this dispatch surface, as the JAX package
keeps them out of its own.

``extract_and_render`` sends both soft-argmax variants to the fused
bottleneck kernel (K3) on CUDA. ``keypoints_tpu/kernels/__init__.py:158``
sends only the joint variant to its fused kernel on the TPU and the
marginal one to the soft-argmax then the raster; on the H100, K3 beats
the soft-argmax kernel then the raster kernel in both variants
(PERF.md). The other TPU dispatch rules there (the B=1 marginal routing,
``xla_only``, the lane-tile width limits) work around XLA:TPU and Mosaic
and have no counterpart here.
"""

from __future__ import annotations

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import (fused_bottleneck_cuda, gaussian_cuda,
                                         group_norm_cuda, pool_cuda,
                                         spatial_softmax_cuda, warp_cuda)
from keypoints_tpu_torch.ops.gaussian import gaussian_maps as _plain_gaussian
from keypoints_tpu_torch.ops.group_norm import \
    group_norm_relu as _plain_group_norm_relu
from keypoints_tpu_torch.ops.pool import max_pool_2x2 as _plain_pool
from keypoints_tpu_torch.ops.spatial_softmax import spatial_softmax as _plain
from keypoints_tpu_torch.ops.warp import grid_sample as _plain_grid_sample
from keypoints_tpu_torch.ops.warp import upsample_field_aligned


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no {what} for device {t.device}")


def spatial_softmax(heatmaps: torch.Tensor, temperature: float = 1.0,
                    variant: str = "marginal",
                    align_corners: bool = DEFAULT_ALIGN_CORNERS
                    ) -> torch.Tensor:
    """Soft-argmax ``(B, K, H, W) -> (B, K, 2)``, kernel on CUDA, plain on CPU.

    Differentiable on both: on CUDA through ``SpatialSoftmax``, whose
    backward is the CUDA backward kernel. Both variants and every batch size
    take the kernel on CUDA.
    """
    if _on_cuda(heatmaps, "soft-argmax"):
        return spatial_softmax_cuda.spatial_softmax_autograd(
            heatmaps, temperature, variant, align_corners)
    return _plain(heatmaps, temperature, variant, align_corners)


def gaussian_maps(keypoints: torch.Tensor, height: int, width: int,
                  sigma: float = 0.1,
                  align_corners: bool = DEFAULT_ALIGN_CORNERS) -> torch.Tensor:
    """Gaussian raster ``(B, K, 2) -> (B, K, H, W)``, kernel on CUDA (forward
    and backward), plain on CPU."""
    if _on_cuda(keypoints, "Gaussian raster"):
        return gaussian_cuda.gaussian_maps_cuda(keypoints, height, width,
                                                sigma, align_corners)
    return _plain_gaussian(keypoints, height, width, sigma, align_corners)


def warp_sample(image: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros",
                align_corners: bool = DEFAULT_ALIGN_CORNERS) -> torch.Tensor:
    """Bilinear warp for the data path (augmentation, no gradient): the CUDA
    warp on CUDA, ``ops.warp.grid_sample`` on CPU. Output in the image's
    dtype. The TPU path's ``y_window`` band has no counterpart (see
    ``warp_cuda``)."""
    if _on_cuda(image, "warp"):
        return warp_cuda.warp_bilinear_cuda(image.contiguous(),
                                            grid.float().contiguous(),
                                            padding_mode, align_corners)
    return _plain_grid_sample(image, grid, padding_mode, align_corners)


def warp_sample_field(image: torch.Tensor, field: torch.Tensor,
                      out_height: int, out_width: int,
                      padding_mode: str = "zeros",
                      align_corners: bool = DEFAULT_ALIGN_CORNERS
                      ) -> torch.Tensor:
    """Warp from a coarse (B, F, F, 2) field (data path, no gradient):
    ``upsample_field_aligned(field, Ho, Wo)`` then the bilinear sample.

    On CUDA the field kernel (K5) at every output size: the dense grid never
    exists, and the result equals the upsample then the dense-grid kernel
    bit for bit. On the CPU the upsample and ``ops.warp.grid_sample``.
    Output in the image's dtype. The JAX package sends warps at most 128
    wide to the upsample and its dense warp instead
    (``keypoints_tpu/kernels/__init__.py``), a rule timed on a TPU, where
    XLA overlapped the upsample with the sibling warp; here the eager
    upsample runs alone on the stream, and at celeba128's b128 3×128² it
    and K4 take ~14× K5's time on the H100 (PERF.md).
    """
    ho, wo = int(out_height), int(out_width)
    field = field.float()
    if _on_cuda(image, "warp"):
        return warp_cuda.warp_field_cuda(image.contiguous(), field.contiguous(),
                                         ho, wo, padding_mode, align_corners)
    return _plain_grid_sample(image, upsample_field_aligned(field, ho, wo),
                              padding_mode, align_corners)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2×2/stride-2 max pool, NCHW: the CUDA kernels (forward and backward)
    on CUDA, ``ops.pool.max_pool_2x2`` on CPU. Differentiable on both; the
    gradient goes to each window's first maximum in row-major order."""
    if _on_cuda(x, "max pool"):
        return pool_cuda.max_pool_2x2_cuda(x.contiguous())
    return _plain_pool(x)


def group_norm_relu(x: torch.Tensor, norm: torch.nn.GroupNorm,
                    conv_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(norm(x + conv_bias))`` for a conv block's ``(N, C, H, W)``
    output, in ``x``'s dtype, statistics and affine in float32 (``norm``'s
    groups, eps and float32 weight and bias); ``conv_bias``, where given,
    the block's conv bias in ``x``'s dtype, for a conv run without it. On
    CUDA the GroupNorm + ReLU kernels (forward and backward,
    ``group_norm_cuda.GroupNormReLU``; they add the conv bias as they load
    ``x`` and give its gradient), picked by ``x``'s strides: channels_last
    (``group_norm_cuda.nhwc``) the NHWC pair, NCHW-contiguous the NCHW
    pair, anything else made contiguous first; on CPU
    ``ops.group_norm.group_norm_relu`` on NCHW, whose gradient is
    autograd's. Differentiable in ``x``, the affine parameters and the conv
    bias on both."""
    if _on_cuda(x, "GroupNorm + ReLU"):
        if not group_norm_cuda.nhwc(x):
            x = x.contiguous()
        return group_norm_cuda.group_norm_relu_autograd(
            x, norm.weight, norm.bias, norm.num_groups, norm.eps, conv_bias)
    return _plain_group_norm_relu(x.contiguous(), norm.num_groups,
                                  norm.weight, norm.bias, norm.eps,
                                  conv_bias)


def conv_group_norm_relu(conv: torch.nn.Module, norm: torch.nn.GroupNorm,
                         x: torch.Tensor) -> torch.Tensor:
    """``relu(norm(conv(x)))`` for a conv block: ``conv`` a
    ``models.nets.Conv2d`` (``convolve(x, bias)``, ``compute_dtype``). On
    CUDA the conv runs without its bias and :func:`group_norm_relu` adds it
    in the GroupNorm + ReLU kernels, bit for bit the add PyTorch would run
    after a cuDNN conv, and sums its gradient there. On the CPU the conv
    keeps it: oneDNN adds a bf16 conv's bias inside its float32 sums,
    before the one rounding, so an add after the conv would change the
    CPU's results."""
    bias = conv.bias.to(conv.compute_dtype)
    if _on_cuda(x, "GroupNorm + ReLU"):
        return group_norm_relu(conv.convolve(x, None), norm, bias)
    return group_norm_relu(conv.convolve(x, bias), norm)


def extract_and_render(heatmaps: torch.Tensor, out_height: int,
                       out_width: int, temperature: float = 1.0,
                       sigma: float = 0.1, variant: str = "marginal",
                       align_corners: bool = DEFAULT_ALIGN_CORNERS
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The keypoint bottleneck: heatmaps → (keypoints, Gaussian maps).

    On CUDA one fused kernel (K3,
    ``fused_bottleneck_cuda.SoftargmaxRasterFused``) in both variants; its
    keypoints and maps equal the soft-argmax kernel's then the raster
    kernel's bit for bit. It takes every output size whose coordinate
    table fits a block's 227 KB of shared memory
    (``fused_bottleneck_cuda.table_floats``): up to 64 a side, Ho + Wo up
    to 58,112, as the raster's backward. On CPU the plain soft-argmax then
    the plain raster (``ops.fused_bottleneck`` is that composition).
    Differentiable in the heatmaps on both.
    """
    if _on_cuda(heatmaps, "keypoint bottleneck"):
        return fused_bottleneck_cuda.softargmax_raster_autograd(
            heatmaps, out_height, out_width, temperature, sigma,
            align_corners, variant)
    kp = spatial_softmax(heatmaps, temperature, variant, align_corners)
    return kp, gaussian_maps(kp, out_height, out_width, sigma, align_corners)


__all__ = ["spatial_softmax", "gaussian_maps", "warp_sample",
           "warp_sample_field", "max_pool_2x2", "group_norm_relu",
           "extract_and_render", "spatial_softmax_cuda", "gaussian_cuda",
           "fused_bottleneck_cuda", "warp_cuda", "pool_cuda",
           "group_norm_cuda"]
