"""Wrappers of the hand-written CUDA banded warps (``csrc/warp_experimental.cu``).

:func:`warp_bilinear_tree_cuda` replaces
``keypoints_tpu/kernels/experimental.py`` ``warp_bilinear_tree`` (K7: a
band of source rows for each block of 8 output rows) on NVIDIA Hopper,
:func:`warp_bilinear_rowwin_cuda` replaces ``warp_bilinear_rowwin`` (K8: a
band for each output row). Both sample a bf16 (B, C, H, W) image at a
(B, Ho, Wo, 2) f32 grid with ``grid_sample``'s bilinear rule
(``padding_mode`` zeros or border, explicit ``align_corners``); a corner
row outside its band reads as 0. The band is only a mask: a band's threads
read its grid once into shared memory, take the band's start from a
warp-level minimum combined across the band's warps, and then gather each
pixel's corners straight from device memory, skipping rows outside the
band. K7's band (8 output rows) is one block of 256 threads; K8's band (one
row) a slot of whole warps, several rows a block. Nothing of the image is
staged, so nothing limits the band's height and a violated window runs the
same code as a held one; a band's grid must fit in shared memory
(:data:`MAX_BAND_BYTES`). The corner math is K4's, so where the window
holds the result equals ``warp_cuda.warp_bilinear_cuda`` bit for bit.

The band heights come from the caller's ``y_window`` as the JAX entries
compute them (``ops.experimental.tree_window`` and ``rowwin_window``); the
plain versions are ``ops.experimental.warp_bilinear_tree`` and
``warp_bilinear_rowwin``. Forward only, like the TPU kernels: the output
carries no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import _build
from keypoints_tpu_torch.ops.experimental import (BLOCK_ROWS, CHUNK,
                                                  check_args, rowwin_window,
                                                  tree_window)

PADDING = {"zeros": 0, "border": 1}
#: a band's grid points (8 bytes a pixel) in one block's shared memory:
#: Wo up to 3,584 for K7, 28,672 for K8
MAX_BAND_BYTES = 224 * 1024

#: K7 launches so far; the wrapper adds one per launch and nowhere else
tree_launches = 0
#: K8 launches so far
rowwin_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _band(name: str, image: torch.Tensor, grid: torch.Tensor,
          padding_mode: str, align_corners: bool, win: int,
          unit: int) -> torch.Tensor:
    _build.require(image, f"{name} image", (torch.bfloat16,), 4)
    _build.require(grid, f"{name} grid", (torch.float32,), 4)
    b, c, h, w = image.shape
    if grid.device != image.device:
        raise ValueError(f"{name}: grid on {grid.device}, image on "
                         f"{image.device}")
    if grid.data_ptr() % 8:
        raise ValueError(f"{name} needs a grid aligned to 8 bytes (each "
                         f"(x, y) point is one load)")
    if h * w >= 2 ** 31 or b > 65535:
        raise ValueError(f"{name} takes H*W < 2**31 and B <= 65535, got "
                         f"{b}x{h}x{w}")
    ho, wo = grid.shape[1:3]
    if 8 * unit * wo > MAX_BAND_BYTES:
        raise ValueError(f"{name} takes Wo <= {MAX_BAND_BYTES // (8 * unit)} "
                         f"(a band's grid in shared memory), got {wo}")
    out = torch.empty((b, c, ho, wo), dtype=image.dtype, device=image.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("kp_warp_band", _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P, _P, _P, _P)
    _build.launch(fn, image, f"{name} ({b}x{c}x{h}x{w} -> {ho}x{wo}, "
                  f"band {win})", unit, PADDING[padding_mode],
                  int(bool(align_corners)), b, c, h, w, ho, wo, win,
                  image.data_ptr(), grid.data_ptr(), out.data_ptr())
    return out


def warp_bilinear_tree_cuda(image: torch.Tensor, grid: torch.Tensor,
                            padding_mode: str = "zeros",
                            align_corners: bool = DEFAULT_ALIGN_CORNERS,
                            y_window: int | None = None) -> torch.Tensor:
    """K7: sample bf16 ``image`` (B, C, H, W), H even, at ``grid`` (B, Ho,
    Wo, 2), Ho a multiple of 8, through a band of ``tree_window(y_window,
    H)`` rows for each block of 8 output rows → (B, C, Ho, Wo) bf16.

    Both tensors contiguous on one CUDA device, grid f32 aligned to 8
    bytes. Launches on the current stream and does not synchronise.
    """
    global tree_launches
    check_args("warp_bilinear_tree", image, grid, padding_mode, 2)
    out = _band("warp_bilinear_tree", image, grid, padding_mode,
                align_corners, tree_window(y_window, image.shape[2]),
                BLOCK_ROWS)
    with _build.lock:
        tree_launches += 1
    return out


def warp_bilinear_rowwin_cuda(image: torch.Tensor, grid: torch.Tensor,
                              padding_mode: str = "zeros",
                              align_corners: bool = DEFAULT_ALIGN_CORNERS,
                              y_window: int = 32) -> torch.Tensor:
    """K8: sample bf16 ``image`` (B, C, H, W), H a multiple of 16, at
    ``grid`` (B, Ho, Wo, 2), Ho a multiple of 8, through a band of
    ``rowwin_window(y_window, H)`` rows for each output row → (B, C, Ho,
    Wo) bf16.

    Both tensors contiguous on one CUDA device, grid f32 aligned to 8
    bytes. Launches on the current stream and does not synchronise.
    """
    global rowwin_launches
    check_args("warp_bilinear_rowwin", image, grid, padding_mode, CHUNK)
    out = _band("warp_bilinear_rowwin", image, grid, padding_mode,
                align_corners, rowwin_window(y_window, image.shape[2]), 1)
    with _build.lock:
        rowwin_launches += 1
    return out
