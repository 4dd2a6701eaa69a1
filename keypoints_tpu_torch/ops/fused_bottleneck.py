"""The keypoint bottleneck, plain — the function of ``keypoints_tpu/kernels/fused_bottleneck.py:121``.

``softargmax_raster`` is the soft-argmax (either published variant)
followed by the isotropic Gaussian raster of its keypoints: exactly what
the JAX package's fused Pallas kernel ``softargmax_raster_fused`` computes
and what its tests hold it to (``spatial_softmax`` then ``gaussian_maps``).

The plain PyTorch version: the oracle of the CUDA fused kernel (K3) in
``keypoints_tpu_torch.kernels.fused_bottleneck_cuda`` (its autograd is the
oracle of the kernel's backward), and the path for CPU tensors only
(``keypoints_tpu_torch.kernels.extract_and_render`` dispatches).
"""

from __future__ import annotations

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.ops.gaussian import gaussian_maps
from keypoints_tpu_torch.ops.spatial_softmax import spatial_softmax


def softargmax_raster(heatmaps: torch.Tensor, out_height: int,
                      out_width: int, temperature: float = 1.0,
                      sigma: float = 0.1,
                      align_corners: bool = DEFAULT_ALIGN_CORNERS,
                      variant: str = "joint"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, K, H, W)`` heatmaps → ``((B, K, 2)`` keypoints ``(x, y)``,
    ``(B, K, Ho, Wo)`` Gaussian maps); ``Ho, Wo`` may differ from ``H, W``."""
    kp = spatial_softmax(heatmaps, temperature, variant, align_corners)
    return kp, gaussian_maps(kp, out_height, out_width, sigma, align_corners)
