"""2×2/stride-2 max pool — port of ``keypoints_tpu/models/vgg.py:40``
``max_pool_2x2``, in NCHW (the port's layout; the JAX function is NHWC).

The plain version of the CUDA pool (``keypoints_tpu_torch.kernels.pool_cuda``,
K6) and the path for CPU tensors. The four corners of each window are
stacked in row-major order (h0w0, h0w1, h1w0, h1w1) and the pooled value is
gathered at ``argmax``, which returns the first maximum. Autograd through
the gather then sends the gradient to that corner alone: the routing of
XLA's select-and-scatter (JAX's gradient) and of ``F.max_pool2d``, exact on
ties (ReLU plateaus, equal bf16 values). A NaN counts as the largest value,
as ``argmax`` and ``F.max_pool2d`` count it.
"""

from __future__ import annotations

import torch


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``(N, C, H, W) -> (N, C, H/2, W/2)`` in ``x``'s dtype; H and W even."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"max_pool_2x2 needs even H and W, got {h}x{w}")
    v = x.reshape(n, c, h // 2, 2, w // 2, 2)
    corners = torch.stack([v[:, :, :, 0, :, 0], v[:, :, :, 0, :, 1],
                           v[:, :, :, 1, :, 0], v[:, :, :, 1, :, 1]], dim=-1)
    first = corners.argmax(dim=-1, keepdim=True)
    return corners.gather(-1, first).squeeze(-1)
