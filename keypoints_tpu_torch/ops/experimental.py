"""Banded bilinear warps of bf16 images — plain versions of K7 and K8.

Port of what ``keypoints_tpu/kernels/experimental.py`` computes:
:func:`warp_bilinear_tree` (``warp_bilinear_tree``, :157) and
:func:`warp_bilinear_rowwin` (``warp_bilinear_rowwin``, :272). They are the
oracle of the CUDA kernels (``keypoints_tpu_torch.kernels.experimental``)
and the path for CPU tensors.

Both are ``grid_sample`` (bilinear, ``padding_mode`` zeros or border,
explicit ``align_corners``) of a bf16 (B, C, H, W) image at a (B, Ho, Wo, 2)
grid, read through a band of source rows: a corner row outside the band
reads as 0. The x corners and weights are ``warp_pallas._grid_math``'s
(``ops.warp.grid_sample``'s), the y corners and weights
``experimental._y_corners``' eq-mask form. Each output pixel is
``(v[y0,x0]·wx0 + v[y0,x1]·wx1)·wy0 + (v[y1,x0]·wx0 + v[y1,x1]·wx1)·wy1``
in f32 from the bf16 values, rounded once to bf16.

* K7 (``warp_bilinear_tree``): one band per block of 8 output rows.
  ``y_window`` None, or a rounded window of H rows or more, means no band.
  Otherwise the band has ``win = min(H, ceil16(y_window + 32))`` rows (even)
  from ``start = floor16(clip(min floor(iy) over the block, 0, H - win))``.
* K8 (``warp_bilinear_rowwin``): one band per output row, of
  ``win = min(H, ceil16(y_window + 16))`` rows from
  ``start = floor16(clip(min floor(iy) over the row, 0, H - win))``.

While the window holds (every corner row of a block or row lies in its
band) both equal ``grid_sample``; where it does not, the rows past the band
read as 0, which is the TPU kernels' degradation (the select tree's zero
rows, the row window's unvisited chunks). No corner row lies above
``start``, since ``start`` never exceeds the smallest corner row.
"""

from __future__ import annotations

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS, normalized_to_pixel

BLOCK_ROWS = 8   # K7's band is shared by a block of this many output rows
CHUNK = 16       # bands start on, and K8's windows are counted in, 16 rows


def _ceil16(n: int) -> int:
    return -(-n // CHUNK) * CHUNK


def tree_window(y_window: int | None, height: int) -> int:
    """K7's band height: ``height`` when there is no band."""
    if y_window is None:
        return height
    win = min(height, max(CHUNK, _ceil16(int(y_window) + 2 * BLOCK_ROWS
                                          + CHUNK)))
    return win + win % 2


def rowwin_window(y_window: int, height: int) -> int:
    """K8's band height."""
    return min(height, _ceil16(int(y_window) + CHUNK))


def check_args(name: str, image: torch.Tensor, grid: torch.Tensor,
               padding_mode: str, row_multiple: int) -> None:
    """Raise ``ValueError`` where the JAX entry rejects its input: a non-bf16
    image, H not a multiple of ``row_multiple``, Ho not a multiple of 8, an
    unknown ``padding_mode``, or shapes that do not match."""
    if image.ndim != 4 or grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(f"{name} needs a (B, C, H, W) image and a "
                         f"(B, Ho, Wo, 2) grid, got {tuple(image.shape)} and "
                         f"{tuple(grid.shape)}")
    b, _, h, _ = image.shape
    if image.dtype != torch.bfloat16 or h % row_multiple:
        raise ValueError(f"{name} needs a bf16 image with H a multiple of "
                         f"{row_multiple}, got {image.dtype} with H={h}")
    if grid.shape[0] != b:
        raise ValueError(f"{name}: grid batch {grid.shape[0]} != image "
                         f"batch {b}")
    if grid.shape[1] % BLOCK_ROWS:
        raise ValueError(f"output height must be a multiple of {BLOCK_ROWS}; "
                         f"got {grid.shape[1]}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")


def _banded_sample(image: torch.Tensor, grid: torch.Tensor, padding_mode: str,
                   align_corners: bool, win: int, group: int) -> torch.Tensor:
    """The warp with a band of ``win`` rows per group of ``group`` output
    rows (``win`` = H: no band)."""
    b, c, h, w = image.shape
    _, ho, wo, _ = grid.shape
    grid = grid.float()
    ix = normalized_to_pixel(grid[..., 0], w, align_corners)     # (B, Ho, Wo)
    iy = normalized_to_pixel(grid[..., 1], h, align_corners)
    if padding_mode == "border":
        ix = ix.clamp(0.0, w - 1)
        iy = iy.clamp(0.0, h - 1)
    x0f = torch.floor(ix)
    y0f = torch.floor(iy)
    fx = ix - x0f
    fy = iy - y0f
    x0 = x0f.clamp(0, w - 1).long()
    x1 = (x0f + 1.0).clamp(0, w - 1).long()
    y0 = y0f.clamp(0, h - 1).long()
    y1 = (y0f + 1.0).clamp(0, h - 1).long()
    zero = torch.zeros_like(fx)
    if padding_mode == "zeros":
        wx0 = torch.where((x0f >= 0) & (x0f <= w - 1), 1.0 - fx, zero)
        wx1 = torch.where((x0f + 1 >= 0) & (x0f + 1 <= w - 1), fx, zero)
        wy0 = torch.where((y0f >= 0) & (y0f <= h - 1), 1.0 - fy, zero)
        wy1 = torch.where((y0f + 1 >= 0) & (y0f + 1 <= h - 1), fy, zero)
    else:
        wx0, wx1, wy0, wy1 = 1.0 - fx, fx, 1.0 - fy, fy

    if win < h:
        low = y0f.reshape(b, ho // group, group * wo).amin(-1)
        start = low.clamp(0, h - win).long() // CHUNK * CHUNK
        start = start.repeat_interleave(group, 1)[:, :, None]     # (B, Ho, 1)
        in0 = (y0 >= start) & (y0 < start + win)
        in1 = (y1 >= start) & (y1 < start + win)
    else:
        in0 = in1 = None

    flat = image.float().reshape(b, c, h * w)

    def row(yi, inside):
        def at(xi):
            idx = (yi * w + xi).reshape(b, 1, -1).expand(b, c, -1)
            return torch.gather(flat, 2, idx).reshape(b, c, ho, wo)
        hx = at(x0) * wx0[:, None] + at(x1) * wx1[:, None]
        if inside is not None:
            hx = torch.where(inside[:, None], hx, torch.zeros_like(hx))
        return hx

    out = row(y0, in0) * wy0[:, None] + row(y1, in1) * wy1[:, None]
    return out.to(image.dtype)


def warp_bilinear_tree(image: torch.Tensor, grid: torch.Tensor,
                       padding_mode: str = "zeros",
                       align_corners: bool = DEFAULT_ALIGN_CORNERS,
                       y_window: int | None = None) -> torch.Tensor:
    """K7's warp: bf16 (B, C, H, W) with even H at (B, Ho, Wo, 2), Ho a
    multiple of 8, with an optional band per block of 8 output rows →
    (B, C, Ho, Wo) bf16. No gradient."""
    check_args("warp_bilinear_tree", image, grid, padding_mode, 2)
    with torch.no_grad():
        return _banded_sample(image, grid, padding_mode, align_corners,
                              tree_window(y_window, image.shape[2]),
                              BLOCK_ROWS)


def warp_bilinear_rowwin(image: torch.Tensor, grid: torch.Tensor,
                         padding_mode: str = "zeros",
                         align_corners: bool = DEFAULT_ALIGN_CORNERS,
                         y_window: int = 32) -> torch.Tensor:
    """K8's warp: bf16 (B, C, H, W) with H a multiple of 16 at (B, Ho, Wo,
    2), Ho a multiple of 8, with a band per output row → (B, C, Ho, Wo)
    bf16. No gradient."""
    check_args("warp_bilinear_rowwin", image, grid, padding_mode, CHUNK)
    with torch.no_grad():
        return _banded_sample(image, grid, padding_mode, align_corners,
                              rowwin_window(y_window, image.shape[2]), 1)
