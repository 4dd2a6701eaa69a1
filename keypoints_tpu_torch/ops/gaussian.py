"""Gaussian heatmap rasterizer — port of ``keypoints_tpu/ops/gaussian.py``.

Each keypoint ``(x_k, y_k)`` in normalized [-1, 1] coordinates is rendered
as ``G_k(u, v) = exp(-((u - x_k)^2 + (v - y_k)^2) / (2 sigma^2))`` on an
``H x W`` grid, as the outer product of two 1-D Gaussians.

The plain PyTorch version: the oracle for the CUDA raster in
``keypoints_tpu_torch.kernels.gaussian_cuda`` (its autograd is the oracle
for the CUDA backward), and the path for CPU tensors only
(``keypoints_tpu_torch.kernels.gaussian_maps`` dispatches).
"""

from __future__ import annotations

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS, axis_coords


def gaussian_maps(keypoints: torch.Tensor, height: int, width: int,
                  sigma: float = 0.1,
                  align_corners: bool = DEFAULT_ALIGN_CORNERS) -> torch.Tensor:
    """Render ``(B, K, 2)`` keypoints (``(x, y)`` order) to ``(B, K, H, W)`` maps."""
    x = keypoints[..., 0]                                    # (B, K)
    y = keypoints[..., 1]
    us = axis_coords(width, align_corners, keypoints.dtype, keypoints.device)
    vs = axis_coords(height, align_corners, keypoints.dtype, keypoints.device)
    inv = 1.0 / (2.0 * sigma * sigma)
    gx = torch.exp(-((us - x[..., None]) ** 2) * inv)        # (B, K, W)
    gy = torch.exp(-((vs - y[..., None]) ** 2) * inv)        # (B, K, H)
    return gy[..., :, None] * gx[..., None, :]               # (B, K, H, W)
