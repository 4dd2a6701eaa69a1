"""Hand-written CUDA kernels and their dispatchers.

A CUDA tensor goes to the kernel, a CPU tensor to the kernel's plain PyTorch
version (``keypoints_tpu_torch.ops``), and any other device raises. There is
no switch that forces the plain path on CUDA and no fallback when a launch
fails. The kernel modules (``spatial_softmax_cuda``: its wrapper, build and
launch count) are submodules of this package.
"""

from __future__ import annotations

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import spatial_softmax_cuda
from keypoints_tpu_torch.ops.spatial_softmax import spatial_softmax as _plain


def spatial_softmax(heatmaps: torch.Tensor, temperature: float = 1.0,
                    variant: str = "marginal",
                    align_corners: bool = DEFAULT_ALIGN_CORNERS
                    ) -> torch.Tensor:
    """Soft-argmax ``(B, K, H, W) -> (B, K, 2)``, kernel on CUDA, plain on CPU.

    Both variants and every batch size take the kernel on CUDA; the JAX
    dispatcher's B=1 marginal routing works around an XLA:TPU miscompile
    that has no counterpart here.
    """
    if heatmaps.device.type == "cuda":
        return spatial_softmax_cuda.spatial_softmax_cuda(
            heatmaps, temperature, variant, align_corners)
    if heatmaps.device.type == "cpu":
        return _plain(heatmaps, temperature, variant, align_corners)
    raise ValueError(f"no soft-argmax for device {heatmaps.device}")


__all__ = ["spatial_softmax", "spatial_softmax_cuda"]
