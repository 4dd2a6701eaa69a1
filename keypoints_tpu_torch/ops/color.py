"""Color jitter — port of ``keypoints_tpu/ops/color.py``.

Brightness, contrast and saturation with per-example factors, torchvision's
semantics:

* brightness: ``img * f``,             f ~ U[max(0, 1-b), 1+b]
* contrast:   ``mean + (img - mean) * f`` with mean = grayscale mean
* saturation: ``gray + (img - gray) * f`` per pixel

Images are NCHW float in [0, 1]; the output is clipped back to [0, 1].

The JAX function draws and applies in one call. Here the two are split:
:func:`draw_jitter` draws the factors from a ``torch.Generator`` (in the
image's dtype, as JAX draws them), and :func:`apply_jitter` is the
deterministic part, so a test can hand it the factors JAX drew.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# ITU-R 601 luma weights, what torchvision's rgb_to_grayscale uses.
_LUMA = (0.299, 0.587, 0.114)


class JitterFactors(NamedTuple):
    """Per-example factors, each (B, 1, 1, 1) in the image's dtype, or None
    where the strength is 0 (saturation also where the image is not RGB)."""
    brightness: Optional[torch.Tensor]
    contrast: Optional[torch.Tensor]
    saturation: Optional[torch.Tensor]


def _factor(generator: torch.Generator, strength: float, batch: int,
            dtype: torch.dtype) -> Optional[torch.Tensor]:
    if strength <= 0:
        return None
    lo, hi = max(0.0, 1.0 - strength), 1.0 + strength
    u = torch.rand((batch, 1, 1, 1), generator=generator, dtype=dtype,
                   device=generator.device)
    return u * (hi - lo) + lo


def draw_jitter(generator: torch.Generator, batch: int, channels: int,
                brightness: float = 0.0, contrast: float = 0.0,
                saturation: float = 0.0,
                dtype: torch.dtype = torch.float32) -> JitterFactors:
    """Draw the factors of :func:`color_jitter` on ``generator``'s device."""
    return JitterFactors(
        _factor(generator, brightness, batch, dtype),
        _factor(generator, contrast, batch, dtype),
        _factor(generator, saturation, batch, dtype) if channels == 3
        else None)


def _grayscale(image: torch.Tensor) -> torch.Tensor:
    if image.shape[1] == 3:
        r, g, b = image.split(1, dim=1)
        return r * _LUMA[0] + g * _LUMA[1] + b * _LUMA[2]
    return image.mean(dim=1, keepdim=True)


def apply_jitter(image: torch.Tensor, factors: JitterFactors) -> torch.Tensor:
    """Apply brightness, contrast and saturation with the given factors."""
    out = image
    if factors.brightness is not None:
        out = out * factors.brightness
    if factors.contrast is not None:
        mean = _grayscale(out).mean(dim=(2, 3), keepdim=True)
        out = mean + (out - mean) * factors.contrast
    if factors.saturation is not None and image.shape[1] == 3:
        gray = _grayscale(out)
        out = gray + (out - gray) * factors.saturation
    return out.clamp(0.0, 1.0)


def color_jitter(generator: torch.Generator, image: torch.Tensor,
                 brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0) -> torch.Tensor:
    """Brightness/contrast/saturation jitter with per-example factors."""
    b, c = image.shape[:2]
    return apply_jitter(image, draw_jitter(generator, b, c, brightness,
                                           contrast, saturation, image.dtype))
