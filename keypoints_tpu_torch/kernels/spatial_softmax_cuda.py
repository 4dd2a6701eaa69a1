"""Wrappers of the hand-written CUDA soft-argmax (``csrc/spatial_softmax.cu``).

Replaces ``keypoints_tpu/kernels/spatial_softmax_pallas.py``
``spatial_softmax_pallas`` on NVIDIA Hopper, forward (K1) and backward
(K1b), both variants. The kernels come from the port's one kernel library
(``kernels/_build.py``). :class:`SpatialSoftmax` is the
``torch.autograd.Function`` that carries the gradient: its forward is the
forward kernel, its backward the backward kernel, as the JAX package's
``custom_vjp`` pairs the two Pallas kernels.

The plain PyTorch version of the same function is
``keypoints_tpu_torch.ops.spatial_softmax``: the tests and ``chip_smoke.py``
compare against it and its autograd. Nothing on the CUDA path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import _build

VARIANTS = {"joint": 0, "marginal": 1}
#: H and W at or below this take the warp-per-heatmap kernels (the heatmap
#: in registers, a lane reading 16-byte quads of a row); a larger H or W
#: takes the block-per-heatmap kernels
WARP_MAX_SIDE = 64
#: H + W of a marginal heatmap above WARP_MAX_SIDE a side: the block kernel
#: keeps its column and row sums in shared memory
MAX_MARGINAL_SUMS = 4096

#: forward kernel launches so far; the wrapper adds one per launch, nowhere else
launches = 0
#: backward kernel launches so far
bwd_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def check_heatmaps(heatmaps: torch.Tensor, variant: str, what: str) -> None:
    """Raise unless ``heatmaps`` is what the soft-argmax kernels take: a
    contiguous 4-D float32 CUDA tensor with H, W >= 1 and H*W < 2**31, and
    a known variant; a marginal heatmap above 64 a side also needs
    H + W <= 4096 (its sums in shared memory)."""
    _build.require(heatmaps, what, (torch.float32,), 4)
    if variant not in VARIANTS:
        raise ValueError(f"unknown spatial softmax variant: {variant!r}")
    h, w = heatmaps.shape[2:]
    if h < 1 or w < 1 or h * w >= 2 ** 31:
        raise ValueError(f"{what} takes H, W >= 1 with H*W < 2**31, got "
                         f"{h}x{w}")
    if (variant == "marginal" and max(h, w) > WARP_MAX_SIDE
            and h + w > MAX_MARGINAL_SUMS):
        raise ValueError(f"{what} takes H + W <= {MAX_MARGINAL_SUMS} for a "
                         f"marginal heatmap above {WARP_MAX_SIDE} a side "
                         f"(its row and column sums live in shared memory), "
                         f"got {h}x{w}")


def spatial_softmax_cuda(heatmaps: torch.Tensor, temperature: float = 1.0,
                         variant: str = "marginal",
                         align_corners: bool = DEFAULT_ALIGN_CORNERS
                         ) -> torch.Tensor:
    """Forward kernel: ``(B, K, H, W)`` f32 CUDA → ``(B, K, 2)`` f32, ``(x, y)``.

    Launches on the current stream of the tensor's device and does not
    synchronise. Heatmaps of up to 64 a side take the warp-per-heatmap
    kernel, two heatmaps a block, larger ones the block-per-heatmap
    kernel. Raises on anything the kernels do
    not take (:func:`check_heatmaps`): a tensor that is not a contiguous
    float32 CUDA tensor, an empty side, or an unknown variant. The output
    carries no gradient: :class:`SpatialSoftmax` does.
    """
    global launches
    check_heatmaps(heatmaps, variant, "spatial_softmax_cuda")
    b, k, h, w = heatmaps.shape
    out = torch.empty((b, k, 2), dtype=torch.float32, device=heatmaps.device)
    if b * k == 0:
        return out
    fn = _build.entry("kp_spatial_softmax_fwd", _I, _I, _I, _I, _F, _I, _P,
                      _P, _P)
    _build.launch(fn, heatmaps, f"spatial_softmax_fwd (N={b * k}, {h}x{w}, "
                  f"{variant})", VARIANTS[variant], b * k, h, w,
                  1.0 / float(temperature), int(bool(align_corners)),
                  heatmaps.data_ptr(), out.data_ptr())
    with _build.lock:
        launches += 1
    return out


def spatial_softmax_bwd_cuda(heatmaps: torch.Tensor, keypoints: torch.Tensor,
                             grad: torch.Tensor, temperature: float = 1.0,
                             variant: str = "marginal",
                             align_corners: bool = DEFAULT_ALIGN_CORNERS
                             ) -> torch.Tensor:
    """Backward kernel: heatmaps ``(B, K, H, W)``, the forward's keypoints
    and ``dL/dkeypoints`` (both ``(B, K, 2)``), all contiguous f32 CUDA →
    ``dL/dheatmaps`` ``(B, K, H, W)`` f32."""
    global bwd_launches
    check_heatmaps(heatmaps, variant, "spatial_softmax_bwd_cuda")
    b, k, h, w = heatmaps.shape
    for name, t in (("keypoints", keypoints), ("grad", grad)):
        _build.require(t, f"spatial_softmax_bwd_cuda {name}",
                       (torch.float32,), 3)
        if tuple(t.shape) != (b, k, 2) or t.device != heatmaps.device:
            raise ValueError(f"spatial_softmax_bwd_cuda {name} must be "
                             f"({b}, {k}, 2) on {heatmaps.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty_like(heatmaps)
    if b * k == 0:
        return out
    fn = _build.entry("kp_spatial_softmax_bwd", _I, _I, _I, _I, _F, _I, _P,
                      _P, _P, _P, _P)
    _build.launch(fn, heatmaps, f"spatial_softmax_bwd (N={b * k}, {h}x{w}, "
                  f"{variant})", VARIANTS[variant], b * k, h, w,
                  1.0 / float(temperature), int(bool(align_corners)),
                  heatmaps.data_ptr(), keypoints.data_ptr(), grad.data_ptr(),
                  out.data_ptr())
    with _build.lock:
        bwd_launches += 1
    return out


class SpatialSoftmax(torch.autograd.Function):
    """Soft-argmax with the CUDA forward and the CUDA backward.

    Saves the heatmaps and the keypoints; the backward recomputes the
    softmax from them in the kernel, as the TPU kernel does.
    """

    @staticmethod
    def forward(ctx, heatmaps, temperature, variant, align_corners):
        kp = spatial_softmax_cuda(heatmaps, temperature, variant,
                                  align_corners)
        ctx.save_for_backward(heatmaps, kp)
        ctx.args = (temperature, variant, align_corners)
        return kp

    @staticmethod
    def backward(ctx, grad):
        heatmaps, kp = ctx.saved_tensors
        dh = spatial_softmax_bwd_cuda(heatmaps, kp, grad.float().contiguous(),
                                      *ctx.args)
        return dh, None, None, None


def spatial_softmax_autograd(heatmaps: torch.Tensor, temperature: float = 1.0,
                             variant: str = "marginal",
                             align_corners: bool = DEFAULT_ALIGN_CORNERS
                             ) -> torch.Tensor:
    """:class:`SpatialSoftmax` applied: the keypoints carry a ``grad_fn``
    whenever ``heatmaps`` requires grad."""
    return SpatialSoftmax.apply(heatmaps, temperature, variant, align_corners)
