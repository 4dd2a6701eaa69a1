"""Weights and frames the benchmark makes from ``--seed``, on the device.

Weights follow flax's defaults for a fresh model: conv kernels normal with
variance 1 / fan_in (lecun normal), biases 0, GroupNorm scales 1. All
kernels of a model come from one normal draw on a ``torch.Generator`` of
the device, split in name order. Frames are uint8 scenes drawn in blocks
of rows on the device (:func:`frames`).
"""

from __future__ import annotations

import math

import torch

#: salts that keep the benchmark's draws apart from one another
MODEL_SALT, FRAMES_SALT = 11, 17


def _gen(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) % (1 << 62))


def draw(shapes: list, seed: int, salt: int, device) -> dict:
    """``{name: float32 tensor}`` for ``shapes`` [(name, shape)]: 4-d
    shapes are conv kernels, names ending in ``.bias`` are zeros, other
    1-d shapes (GroupNorm scales) are ones."""
    kernels = [(n, s) for n, s in shapes if len(s) == 4]
    total = sum(math.prod(s) for _, s in kernels)
    flat = torch.randn(total, generator=_gen(seed, salt, device),
                       device=device)
    out, at = {}, 0
    for name, shape in shapes:
        if len(shape) == 4:
            n = math.prod(shape)
            fan_in = math.prod(shape[1:])
            out[name] = flat[at:at + n].view(shape) / math.sqrt(fan_in)
            at += n
        elif name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def frames(seed: int, n: int, shape: tuple, device,
           block: int = 4096) -> torch.Tensor:
    """``n`` uint8 frames of ``shape`` (C, H, W), drawn on ``device``: each a
    smooth random scene (an 8x8 grid of colours upsampled bilinearly) under
    its own gain and offset, plus fine noise, so that frames differ from one
    another in brightness and contrast as photographs do."""
    c, h, w = shape
    out = torch.empty((n, c, h, w), dtype=torch.uint8, device=device)
    g = _gen(seed, FRAMES_SALT, device)
    for lo in range(0, n, block):
        m = min(n, lo + block) - lo
        coarse = torch.rand((m, c, 8, 8), generator=g, device=device)
        scene = torch.nn.functional.interpolate(
            coarse, size=(h, w), mode="bilinear", align_corners=True)
        gain = 0.2 + 0.8 * torch.rand((m, 1, 1, 1), generator=g,
                                      device=device)
        offset = (1.0 - gain) * torch.rand((m, 1, 1, 1), generator=g,
                                           device=device)
        fine = torch.rand((m, c, h, w), generator=g, device=device)
        x = offset + gain * (0.85 * scene + 0.15 * fine)
        out[lo:lo + m] = (x * 255.0).round_().clamp_(0, 255).to(torch.uint8)
    return out
