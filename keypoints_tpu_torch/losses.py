"""Reconstruction losses — port of ``keypoints_tpu/losses.py``: pixel L2 and
VGG perceptual."""

from __future__ import annotations

from typing import Callable

import torch

from keypoints_tpu_torch.utils.profiling import span


def l2_loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all pixels (torch ``MSELoss('mean')``)."""
    return torch.mean((recon - target) ** 2)


def make_perceptual_loss(vgg_apply: Callable[[torch.Tensor], dict],
                         layers: tuple[str, ...]) -> Callable:
    """Σ_l mean((VGG_l(recon) − VGG_l(target))²) over ``layers``.

    ``vgg_apply`` maps NCHW [0, 1] images to ``{layer: float32 feature}``
    with its frozen trunk bound (``models.vgg.make_feature_fn``), so the sum
    is taken in float32 whatever the trunk computes in. Under a profiler the
    loss's forward is the span ``kp.loss.perceptual`` around one
    ``kp.loss.vgg`` a trunk pass (``utils.profiling.span``; the backward
    runs later, outside them, and a replayed CUDA graph records neither).
    """
    def loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        with span("kp.loss.perceptual"):
            with span("kp.loss.vgg"):
                fr = vgg_apply(recon)
            with span("kp.loss.vgg"):
                ft = vgg_apply(target)
            total = 0.0
            for name in layers:
                total = total + torch.mean((fr[name] - ft[name]) ** 2)
            return total
    return loss
