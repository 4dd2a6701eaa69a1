"""Conv stacks Φ (``Encoder``) and Ψ (``KeyNet``) — port of ``keypoints_tpu/models/nets.py``.

Plain conv3×3 / GroupNorm / ReLU blocks, NCHW (PyTorch's layout; the JAX
package runs NHWC inside and adapts at the model boundary, so the public
layouts agree). Convs use torch's explicit ``padding=1``, the padding the
JAX package spells ``((1, 1), (1, 1))``, never "same".

Submodules are named after the flax parameter paths (``Conv_{i}``,
``GroupNorm_{i}``, ``head``), so the state dict that
``keypoints_tpu.checkpoint.export_torch_state_dict`` writes without a
rename map loads verbatim.

Compute dtype: conv parameters are stored in the compute dtype (bf16 for
serving) and inputs are cast to it once at the stack's entry; GroupNorm
keeps float32 parameters and takes its statistics and affine in float32,
returning the input's dtype — flax 0.12's ``force_float32_reductions``.

``Decoder`` and ``UpsampleConv`` come with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.GroupNorm):
    """GroupNorm in float32 whatever the input dtype; output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class Encoder(nn.Module):
    """Φ: image (B, C, H, W) → feature map (B, F, H/2^d, W/2^d).

    ``filters[i]`` with ``strides[i]`` per block; d = number of stride-2 blocks.
    """

    def __init__(self, in_channels: int,
                 filters: Sequence[int] = (32, 32, 64, 64, 128),
                 strides: Sequence[int] = (1, 2, 1, 2, 1), groups: int = 8):
        super().__init__()
        self.blocks = []
        cin = in_channels
        for i, (f, s) in enumerate(zip(filters, strides)):
            conv = nn.Conv2d(cin, f, 3, stride=s, padding=1)
            norm = GroupNorm(min(groups, f), f, eps=1e-5)
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"GroupNorm_{i}", norm)
            self.blocks.append((conv, norm))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.blocks[0][0].weight.dtype)
        for conv, norm in self.blocks:
            x = F.relu(norm(conv(x)))
        return x


class KeyNet(nn.Module):
    """Ψ: image (B, C, H, W) → K raw heatmaps (B, K, H/2^d, W/2^d)."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 filters: Sequence[int] = (32, 32, 64, 64, 128),
                 strides: Sequence[int] = (1, 2, 1, 2, 1), groups: int = 8):
        super().__init__()
        self.trunk = Encoder(in_channels, filters, strides, groups)
        # 1x1 head, no norm/activation — raw logits for the spatial softmax
        self.head = nn.Conv2d(filters[-1], num_keypoints, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x))
