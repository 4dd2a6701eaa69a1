"""Coordinate conventions — port of ``keypoints_tpu/coords.py`` on torch tensors.

* Keypoints and sampling grids live on a normalized ``[-1, 1] x [-1, 1]`` square.
* ``x`` indexes the **width** (last) axis, ``y`` the **height** axis; a
  keypoint is stored ``(x, y)``, matching ``grid_sample``'s grid layout.
* ``align_corners=True``:  ``coord(i) = -1 + 2*i/(n-1)`` (pixel centers at ±1).
  ``align_corners=False``: ``coord(i) = -1 + (2*i + 1)/n`` (pixel edges at ±1).

The default is ``align_corners=True``, as in the JAX package.
"""

from __future__ import annotations

import torch

DEFAULT_ALIGN_CORNERS = True


def axis_coords(n: int, align_corners: bool = DEFAULT_ALIGN_CORNERS,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Normalized coordinates of ``n`` pixels along one axis, shape ``(n,)``."""
    i = torch.arange(n, dtype=dtype, device=device)
    if align_corners:
        if n == 1:
            return torch.zeros((1,), dtype=dtype, device=device)
        return -1.0 + 2.0 * i / (n - 1)
    return -1.0 + (2.0 * i + 1.0) / n


def coord_grid(height: int, width: int,
               align_corners: bool = DEFAULT_ALIGN_CORNERS,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str | None = None) -> torch.Tensor:
    """Dense grid of shape ``(height, width, 2)``, ``grid[i, j] = (x_j, y_i)``."""
    ys = axis_coords(height, align_corners, dtype, device)
    xs = axis_coords(width, align_corners, dtype, device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def normalized_to_pixel(coords: torch.Tensor, size: int,
                        align_corners: bool = DEFAULT_ALIGN_CORNERS
                        ) -> torch.Tensor:
    """[-1, 1] coords → fractional pixel indices (grid_sample's unnormalize)."""
    coords = torch.as_tensor(coords)
    if align_corners:
        return (coords + 1.0) * 0.5 * (size - 1)
    return (coords + 1.0) * 0.5 * size - 0.5


def pixel_to_normalized(idx: torch.Tensor, size: int,
                        align_corners: bool = DEFAULT_ALIGN_CORNERS
                        ) -> torch.Tensor:
    """Fractional pixel indices → [-1, 1] coords."""
    idx = torch.as_tensor(idx, dtype=torch.float32)
    if align_corners:
        if size == 1:
            return torch.zeros_like(idx)
        return idx * 2.0 / (size - 1) - 1.0
    return (2.0 * idx + 1.0) / size - 1.0
