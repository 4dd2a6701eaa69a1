"""Reconstruction losses — port of ``keypoints_tpu/losses.py``.

The pixel L2 so far; the VGG perceptual loss comes with the VGG port.
"""

from __future__ import annotations

import torch


def l2_loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all pixels (torch ``MSELoss('mean')``)."""
    return torch.mean((recon - target) ** 2)
