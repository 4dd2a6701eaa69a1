"""Jakab-2018 keypoint autoencoder — port of ``keypoints_tpu/models/autoencoder.py``.

    fmap  = Φ(x_source)                 # appearance stream
    hm    = Ψ(x_target)                 # (B, K, h, w) raw heatmaps
    kp    = spatial_softmax(hm)         # (B, K, 2) (x, y) in [-1, 1]
    G     = gaussian_maps(kp, σ)        # re-rendered bottleneck
    x̂_tgt = decoder(concat(fmap, G))   # reconstruct the target

Images are NCHW in [0, 1]. The heatmaps reach the bottleneck as float32
(the CUDA soft-argmax and raster on CUDA, their plain versions on CPU); the
maps are cast to the feature map's dtype and concatenated after it along the
channels; the reconstruction comes back as float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import extract_and_render, spatial_softmax
from keypoints_tpu_torch.models.nets import Decoder, Encoder, KeyNet


class KeypointAutoencoder(nn.Module):

    def __init__(self, num_keypoints: int, in_channels: int = 3,
                 out_channels: int = 3, sigma: float = 0.1,
                 temperature: float = 1.0, softmax_variant: str = "marginal",
                 align_corners: bool = DEFAULT_ALIGN_CORNERS,
                 encoder_filters: Sequence[int] = (32, 32, 64, 64, 128),
                 encoder_strides: Sequence[int] = (1, 2, 1, 2, 1),
                 decoder_filters: Sequence[int] = (128, 64, 32),
                 decoder_upsample: Sequence[bool] = (True, True, False),
                 groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sigma = sigma
        self.temperature = temperature
        self.softmax_variant = softmax_variant
        self.align_corners = align_corners
        self.encoder = Encoder(in_channels, encoder_filters, encoder_strides,
                               groups, dtype)
        self.keynet = KeyNet(in_channels, num_keypoints, encoder_filters,
                             encoder_strides, groups, dtype)
        self.decoder = Decoder(encoder_filters[-1] + num_keypoints,
                               out_channels, decoder_filters,
                               decoder_upsample, groups, dtype)

    def extract_keypoints(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images → (B, K, 2) keypoints; heatmaps go in as float32."""
        hm = self.keynet(x).float().contiguous()
        return spatial_softmax(hm, self.temperature, self.softmax_variant,
                               self.align_corners)

    def forward(self, x_source: torch.Tensor, x_target: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(NCHW src, NCHW tgt) → (reconstruction NCHW f32, keypoints (B, K, 2))."""
        fmap = self.encoder(x_source)                        # (B, F, h, w)
        hm = self.keynet(x_target).float().contiguous()      # (B, K, h, w)
        h, w = fmap.shape[2:]
        kp, maps = extract_and_render(hm, h, w, self.temperature, self.sigma,
                                      self.softmax_variant, self.align_corners)
        recon = self.decoder(torch.cat([fmap, maps.to(fmap.dtype)], dim=1))
        return recon.float(), kp
