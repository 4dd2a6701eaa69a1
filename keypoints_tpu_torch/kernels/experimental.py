"""The banded warps K7 and K8 — entry points of ``keypoints_tpu/kernels/experimental.py``.

:func:`warp_bilinear_tree` (K7) and :func:`warp_bilinear_rowwin` (K8) keep
the JAX entries' names and signatures, less ``interpret``: a CUDA tensor
goes to the hand-written kernel (``experimental_cuda``), a CPU tensor to
the plain version (``ops.experimental``), any other device raises. Like
the JAX package, which keeps them out of its dispatchers, nothing in the
port calls them; they are not part of ``keypoints_tpu_torch.kernels``'
dispatch surface. What they compute is ``grid_sample`` of a bf16 image
through a band of source rows (see ``ops.experimental``).

The JAX entries' Mosaic limits have no counterpart here:

* W, Wo ≤ 512 (K7): the select-tree kernel gathers inside 128-lane tiles
  and selects across at most four of them; a CUDA gather has no lane tiles.
* W, Wo ≤ 128 (K8): the row-window kernel's lane gather stays inside one
  128-lane tile; a CUDA thread reads any column.
* C ≤ 8 (K8): its accumulator is one (8, Wo) f32 VMEM tile; here each
  thread keeps its channel's sum in a register.

What they still reject, as the JAX entries do, raises ``ValueError``: a
non-bf16 image, odd H (K7), H not a multiple of 16 (K8), Ho not a
multiple of 8, and a ``padding_mode`` other than zeros or border.
"""

from __future__ import annotations

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import _on_cuda, experimental_cuda
from keypoints_tpu_torch.ops import experimental as plain


def warp_bilinear_tree(image: torch.Tensor, grid: torch.Tensor,
                       padding_mode: str = "zeros",
                       align_corners: bool = DEFAULT_ALIGN_CORNERS,
                       y_window: int | None = None) -> torch.Tensor:
    """K7: bf16 (B, C, H, W), H even, at (B, Ho, Wo, 2), Ho a multiple of
    8, with an optional band per block of 8 output rows → (B, C, Ho, Wo)
    bf16, without a gradient."""
    if _on_cuda(image, "banded warp"):
        return experimental_cuda.warp_bilinear_tree_cuda(
            image.contiguous(), grid.detach().float().contiguous(),
            padding_mode, align_corners, y_window)
    return plain.warp_bilinear_tree(image, grid, padding_mode, align_corners,
                                    y_window)


def warp_bilinear_rowwin(image: torch.Tensor, grid: torch.Tensor,
                         padding_mode: str = "zeros",
                         align_corners: bool = DEFAULT_ALIGN_CORNERS,
                         y_window: int = 32) -> torch.Tensor:
    """K8: bf16 (B, C, H, W), H a multiple of 16, at (B, Ho, Wo, 2), Ho a
    multiple of 8, with a band per output row → (B, C, Ho, Wo) bf16,
    without a gradient."""
    if _on_cuda(image, "banded warp"):
        return experimental_cuda.warp_bilinear_rowwin_cuda(
            image.contiguous(), grid.detach().float().contiguous(),
            padding_mode, align_corners, y_window)
    return plain.warp_bilinear_rowwin(image, grid, padding_mode,
                                      align_corners, y_window)
