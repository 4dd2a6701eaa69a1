"""Jakab-2018 keypoint autoencoder — port of ``keypoints_tpu/models/autoencoder.py``.

So far only the geometry stream that keypoint extraction runs:

    hm = Ψ(x)                    # (B, K, h, w) raw heatmaps
    kp = spatial_softmax(hm)     # (B, K, 2) (x, y) in [-1, 1]

Images are NCHW in [0, 1]. The appearance encoder Φ, the Gaussian re-render,
the decoder and ``forward`` come with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import spatial_softmax
from keypoints_tpu_torch.models.nets import KeyNet


class KeypointAutoencoder(nn.Module):

    def __init__(self, num_keypoints: int, in_channels: int = 3,
                 temperature: float = 1.0, softmax_variant: str = "marginal",
                 align_corners: bool = DEFAULT_ALIGN_CORNERS,
                 encoder_filters: Sequence[int] = (32, 32, 64, 64, 128),
                 encoder_strides: Sequence[int] = (1, 2, 1, 2, 1),
                 groups: int = 8):
        super().__init__()
        self.temperature = temperature
        self.softmax_variant = softmax_variant
        self.align_corners = align_corners
        self.keynet = KeyNet(in_channels, num_keypoints, encoder_filters,
                             encoder_strides, groups)

    def extract_keypoints(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images → (B, K, 2) keypoints; heatmaps go in as float32."""
        hm = self.keynet(x).float().contiguous()
        return spatial_softmax(hm, self.temperature, self.softmax_variant,
                               self.align_corners)
