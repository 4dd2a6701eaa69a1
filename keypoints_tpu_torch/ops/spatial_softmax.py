"""Spatial softmax (soft-argmax): heatmaps → normalized keypoint coordinates.

Port of ``keypoints_tpu/ops/spatial_softmax.py``. Two published variants:

* ``joint``    — 2-D softmax over the full H*W plane, then expectations of the
  (x, y) coordinate grids under that distribution.
* ``marginal`` — sum the heatmap over rows / columns first, softmax each 1-D
  marginal separately, take 1-D expectations.

Heatmaps are NCHW ``(B, K, H, W)``; coordinates come back ``(B, K, 2)``,
stored ``(x, y)`` in [-1, 1] per ``keypoints_tpu_torch.coords``.

These are the plain PyTorch versions: the oracle for the CUDA kernel in
``keypoints_tpu_torch.kernels.spatial_softmax_cuda``, and the path for CPU
tensors only (``keypoints_tpu_torch.kernels.spatial_softmax`` dispatches).
Expectations are written as products and sums, not matmuls, so no TF32
setting can change them.
"""

from __future__ import annotations

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS, axis_coords


def spatial_softmax2d(heatmaps: torch.Tensor, temperature: float = 1.0,
                      align_corners: bool = DEFAULT_ALIGN_CORNERS
                      ) -> torch.Tensor:
    """Joint 2-D soft-argmax. ``(B, K, H, W) -> (B, K, 2)`` with ``(x, y)``."""
    b, k, h, w = heatmaps.shape
    logits = heatmaps.reshape(b, k, h * w) / temperature
    probs = torch.softmax(logits, dim=-1)
    xs = axis_coords(w, align_corners, heatmaps.dtype, heatmaps.device)
    ys = axis_coords(h, align_corners, heatmaps.dtype, heatmaps.device)
    grid_x = xs.repeat(h)                        # (H*W,) x varies fastest
    grid_y = ys.repeat_interleave(w)             # (H*W,)
    ex = (probs * grid_x).sum(dim=-1)
    ey = (probs * grid_y).sum(dim=-1)
    return torch.stack([ex, ey], dim=-1)


def marginal_softmax(heatmaps: torch.Tensor, temperature: float = 1.0,
                     align_corners: bool = DEFAULT_ALIGN_CORNERS
                     ) -> torch.Tensor:
    """Marginal soft-argmax: softmax over row/col sums. ``(B,K,H,W) -> (B,K,2)``.

    ``x`` comes from the width marginal ``sum_h heatmap``; ``y`` from the
    height marginal ``sum_w heatmap``.
    """
    hx = heatmaps.sum(dim=2)                     # (B, K, W)  width marginal
    hy = heatmaps.sum(dim=3)                     # (B, K, H)  height marginal
    px = torch.softmax(hx / temperature, dim=-1)
    py = torch.softmax(hy / temperature, dim=-1)
    xs = axis_coords(heatmaps.shape[3], align_corners, heatmaps.dtype,
                     heatmaps.device)
    ys = axis_coords(heatmaps.shape[2], align_corners, heatmaps.dtype,
                     heatmaps.device)
    return torch.stack([(px * xs).sum(dim=-1), (py * ys).sum(dim=-1)], dim=-1)


def spatial_softmax(heatmaps: torch.Tensor, temperature: float = 1.0,
                    variant: str = "marginal",
                    align_corners: bool = DEFAULT_ALIGN_CORNERS
                    ) -> torch.Tensor:
    """Dispatch between the two published soft-argmax variants."""
    if variant == "joint":
        return spatial_softmax2d(heatmaps, temperature, align_corners)
    if variant == "marginal":
        return marginal_softmax(heatmaps, temperature, align_corners)
    raise ValueError(f"unknown spatial softmax variant: {variant!r}")
