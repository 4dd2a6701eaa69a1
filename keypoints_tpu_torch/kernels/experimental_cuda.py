"""Wrappers of the hand-written CUDA banded warps (``csrc/warp_experimental.cu``).

:func:`warp_bilinear_tree_cuda` replaces
``keypoints_tpu/kernels/experimental.py`` ``warp_bilinear_tree`` (K7: a
band of source rows for each block of 8 output rows) on NVIDIA Hopper,
:func:`warp_bilinear_rowwin_cuda` replaces ``warp_bilinear_rowwin`` (K8: a
band for each output row). Both sample a bf16 (B, C, H, W) image at a
(B, Ho, Wo, 2) f32 grid with ``grid_sample``'s bilinear rule
(``padding_mode`` zeros or border, explicit ``align_corners``); a corner
row outside its band reads as 0. Each block of threads takes
:data:`BLOCK_OUTPUT_ROWS` output rows (several bands), stages the source
rows its bands read in shared memory one channel at a time, and samples
from there; a block whose bands read more rows than it reserves, or every
block when the reserve passes what the card lets a block hold
(:func:`smem_limit`), reads them in place, with the same result. The
corner math is K4's, so where the window holds the result equals
``warp_cuda.warp_bilinear_cuda`` bit for bit.

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
#: output rows one block of threads takes (2 K7 bands, 16 K8 bands): 16
#: beat 32 at 256² and tied it at 128² on the H100 (PERF.md)
BLOCK_OUTPUT_ROWS = 16

#: K7 launches so far; the wrapper adds one per launch and nowhere else
tree_launches = 0
#: K8 launches so far
rowwin_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def smem_limit() -> int:
    """The most shared memory, in bytes, a block takes for its staged rows
    on the current device (min(H, win + 2 * BLOCK_OUTPUT_ROWS) rows of W
    bf16 values); a larger reserve is read in place."""
    fn = _build.load().kp_warp_band_smem_limit
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


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
    out = torch.empty((b, c, ho, wo), dtype=image.dtype, device=image.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("kp_warp_band", _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P, _P, _P, _P)
    _build.launch(fn, image, f"{name} ({b}x{c}x{h}x{w} -> {ho}x{wo}, "
                  f"band {win})", unit, BLOCK_OUTPUT_ROWS,
                  PADDING[padding_mode], int(bool(align_corners)), b, c, h, w,
                  ho, wo, win,
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
