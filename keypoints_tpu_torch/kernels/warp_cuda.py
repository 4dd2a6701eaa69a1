"""Wrappers of the hand-written CUDA bilinear warps (``csrc/warp.cu``).

:func:`warp_bilinear_cuda` replaces ``keypoints_tpu/kernels/warp_pallas.py``
``warp_bilinear_pallas`` (K4) on NVIDIA Hopper, :func:`warp_field_cuda`
replaces ``warp_field_pallas`` (K5): the same sampling at a coarse
(B, F, F, 2) field, upsampled per output pixel inside the kernel exactly as
``ops.warp.upsample_field_aligned`` upsamples it, so the dense grid never
exists. Both compute ``torch.nn.functional.grid_sample`` exactly: bilinear, ``padding_mode`` zeros or border, explicit
``align_corners``, with the corner, clip and zero-weight rules of
``warp_pallas._grid_math`` and ``ops/warp.grid_sample``. The output has the
image's dtype (f32 or bf16); all index and weight arithmetic is f32.

What is not carried over, and why:

* ``y_window`` / ``y_row_advance``: the TPU kernel keeps only a band of
  source rows in VMEM because Mosaic cannot gather along sublanes; a CUDA
  gather reads any row, so these kernels compute ``grid_sample``
  everywhere, which is what the Pallas kernels compute whenever the window
  contract (``keypoints_tpu/data/augment.py:122-136``) holds. Nor the field
  kernel's shape limits (Ho a multiple of 8; Wo at most 128 or a multiple
  of it): they follow its 8-row programs and 128-lane chunks.
* ``grids_per_image`` (several grids per image in one call) is not ported.
* Forward only, like the TPU kernel: augmentation is data and takes no
  gradient; the output carries none.

The plain PyTorch versions are ``keypoints_tpu_torch.ops.warp.grid_sample``
and, for the field warp, ``upsample_field_aligned`` followed by it;
``chip_smoke.py`` also times ``F.grid_sample`` beside the dense warp as a
yardstick, which the port never calls.
"""

from __future__ import annotations

import ctypes

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PADDING = {"zeros": 0, "border": 1}

MAX_FIELD = 78     # the field of one image sits in 48 KB of shared memory

#: dense-grid kernel launches so far; the wrapper adds one per launch and
#: nowhere else
launches = 0
#: field kernel launches so far
field_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def warp_bilinear_cuda(image: torch.Tensor, grid: torch.Tensor,
                       padding_mode: str = "zeros",
                       align_corners: bool = DEFAULT_ALIGN_CORNERS
                       ) -> torch.Tensor:
    """Sample ``image`` (B, C, H, W) at ``grid`` (B, Ho, Wo, 2 as (x, y))
    → (B, C, Ho, Wo) in the image's dtype.

    Both tensors contiguous on one CUDA device; image f32 or bf16, grid f32
    aligned to 8 bytes. Launches on the current stream and does not
    synchronise.
    """
    global launches
    _build.require(image, "warp_bilinear_cuda image", tuple(DTYPES), 4)
    _build.require(grid, "warp_bilinear_cuda grid", (torch.float32,), 4)
    b, c, h, w = image.shape
    if grid.shape[0] != b or grid.shape[3] != 2 or grid.device != image.device:
        raise ValueError(f"warp_bilinear_cuda needs a ({b}, Ho, Wo, 2) grid "
                         f"on {image.device}, got {tuple(grid.shape)} on "
                         f"{grid.device}")
    if grid.data_ptr() % 8:
        raise ValueError("warp_bilinear_cuda needs a grid aligned to 8 bytes "
                         "(each (x, y) point is one load)")
    if padding_mode not in PADDING:
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    if h * w >= 2 ** 31:
        raise ValueError(f"warp_bilinear_cuda takes H*W < 2**31, got {h}x{w}")
    ho, wo = grid.shape[1:3]
    out = torch.empty((b, c, ho, wo), dtype=image.dtype, device=image.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("kp_warp_bilinear", _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P, _P, _P, _P)
    _build.launch(fn, image, f"warp_bilinear ({b}x{c}x{h}x{w} -> {ho}x{wo})",
                  DTYPES[image.dtype], PADDING[padding_mode],
                  int(bool(align_corners)), b, c, h, w, ho, wo,
                  image.data_ptr(), grid.data_ptr(), out.data_ptr())
    with _build.lock:
        launches += 1
    return out


def warp_field_cuda(image: torch.Tensor, field: torch.Tensor,
                    out_height: int, out_width: int,
                    padding_mode: str = "zeros",
                    align_corners: bool = DEFAULT_ALIGN_CORNERS
                    ) -> torch.Tensor:
    """Sample ``image`` (B, C, H, W) at ``upsample_field_aligned(field,
    out_height, out_width)`` for a coarse ``field`` (B, F, F, 2 as (x, y))
    → (B, C, Ho, Wo) in the image's dtype.

    Both tensors contiguous on one CUDA device; image f32 or bf16, field
    f32 with 2 <= F <= ``MAX_FIELD``. Launches on the current stream and
    does not synchronise.
    """
    global field_launches
    _build.require(image, "warp_field_cuda image", tuple(DTYPES), 4)
    _build.require(field, "warp_field_cuda field", (torch.float32,), 4)
    b, c, h, w = image.shape
    f = field.shape[1]
    if (tuple(field.shape) != (b, f, f, 2) or field.device != image.device
            or not 2 <= f <= MAX_FIELD):
        raise ValueError(f"warp_field_cuda needs a ({b}, F, F, 2) field with "
                         f"2 <= F <= {MAX_FIELD} on {image.device}, got "
                         f"{tuple(field.shape)} on {field.device}")
    if padding_mode not in PADDING:
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    ho, wo = int(out_height), int(out_width)
    if h * w >= 2 ** 31 or ho * wo >= 2 ** 31 or b > 65535:
        raise ValueError(f"warp_field_cuda takes H*W, Ho*Wo < 2**31 and "
                         f"B <= 65535, got {b}x{h}x{w} -> {ho}x{wo}")
    out = torch.empty((b, c, ho, wo), dtype=image.dtype, device=image.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("kp_warp_field", _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P, _P, _P, _P)
    _build.launch(fn, image, f"warp_field ({b}x{c}x{h}x{w}, F={f} -> "
                  f"{ho}x{wo})", DTYPES[image.dtype], PADDING[padding_mode],
                  int(bool(align_corners)), b, c, h, w, f, ho, wo,
                  image.data_ptr(), field.data_ptr(), out.data_ptr())
    with _build.lock:
        field_launches += 1
    return out
