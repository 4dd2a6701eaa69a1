"""Kulkarni-2019 Transporter — port of ``keypoints_tpu/models/transporter.py``.

For a source frame x_s and a target frame x_t of one trajectory:

    Φ_s, Φ_t = Φ(x_s), Φ(x_t)                       # feature maps
    G_s, G_t = max_k raster(softargmax(Ψ(x)))       # (B, 1, h, w) in [0, 1]
    Φ̂ = (1 − G_s)·(1 − G_t)·sg[Φ_s] + G_t·Φ_t
    x̂_t = decoder(Φ̂),   loss = ‖x̂_t − x_t‖²

The source branch (Φ_s and G_s) runs under ``torch.no_grad()``: the JAX
package stops the gradient of both (``lax.stop_gradient``), so gradients
flow only through the target branch, and no graph of the source is kept.
Images are NCHW in [0, 1]; the heatmaps reach the bottleneck as float32
(``kernels.extract_and_render``: on CUDA the fused kernel K3 in both
variants); the
reconstruction comes back as float32. In bf16 eager torch rounds after each
op of the transport where XLA may fuse, so the port is held to JAX in f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS
from keypoints_tpu_torch.kernels import extract_and_render, spatial_softmax
from keypoints_tpu_torch.models.nets import Decoder, Encoder, KeyNet


class Transporter(nn.Module):

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
        # the transported feature map alone, no keypoint channels
        self.decoder = Decoder(encoder_filters[-1], out_channels,
                               decoder_filters, decoder_upsample, groups,
                               dtype)

    def _heat(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """NCHW image → (keypoints (B, K, 2), attention map (B, 1, h, w)).

        ``amax`` splits the gradient evenly among tied maxima, as
        ``jnp.max``'s VJP does (coincident keypoints; maps that underflow to
        0); ``max(dim).values`` would send it all to one index.
        """
        hm = self.keynet(x).float().contiguous()            # (B, K, h, w)
        h, w = hm.shape[2:]
        kp, g = extract_and_render(hm, h, w, self.temperature, self.sigma,
                                   self.softmax_variant, self.align_corners)
        return kp, g.amax(dim=1, keepdim=True)

    def extract_keypoints(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images → (B, K, 2) keypoints; heatmaps go in as float32."""
        hm = self.keynet(x).float().contiguous()
        return spatial_softmax(hm, self.temperature, self.softmax_variant,
                               self.align_corners)

    def forward(self, x_source: torch.Tensor, x_target: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(NCHW src, NCHW tgt) → (reconstruction of the target, NCHW f32;
        target keypoints (B, K, 2))."""
        with torch.no_grad():
            phi_s = self.encoder(x_source)
            _, g_s = self._heat(x_source)
        phi_t = self.encoder(x_target)
        kp_t, g_t = self._heat(x_target)
        g_s = g_s.to(phi_t.dtype)
        g_t = g_t.to(phi_t.dtype)
        transported = (1.0 - g_s) * (1.0 - g_t) * phi_s + g_t * phi_t
        return self.decoder(transported).float(), kp_t
