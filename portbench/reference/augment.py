"""The training pair of a warp-mode step, worked out again from the seed.

Each step turns a batch of frames into a (source, target) pair by two
independent random thin-plate-spline and affine warps, each followed by
per-image colour jitter (brightness, contrast, saturation; torchvision's
semantics). The random numbers are the program's draws: rows, warps and
jitter factors come from generators seeded by the rule of
:func:`step_seed`, drawn in the order, shapes and dtypes the program draws
them (a jitter factor is drawn, scaled and shifted in the image's dtype,
bfloat16 on the hot path). The arithmetic after the draws is this file's
own, in float32 (the TPS solve in float64), with ``torch``'s own bilinear
upsampling and ``grid_sample``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: ITU-R 601 luma weights
LUMA = (0.299, 0.587, 0.114)
#: salt of the resident frame source's generator (the train loop's rule)
ROW_SALT = 3


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s draws: two words of
    ``SeedSequence([seed, step])`` joined as ``(w0 << 31) ^ w1``."""
    words = np.random.SeedSequence([seed, step]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def draw_rows(seed: int, step: int, n_frames: int, batch: int,
              device) -> torch.Tensor:
    """Indices of the ``batch`` store frames step ``step`` trains on."""
    g = generator(seed + ROW_SALT, step, device)
    return torch.randint(0, n_frames, (batch,), generator=g, device=device)


def _uniform(g, shape, bound):
    u = torch.rand(shape, generator=g, device=g.device)
    return u * (2 * bound) - bound


def draw_pair(seed: int, step: int, batch: int, channels: int, aug: dict,
              factor_dtype: torch.dtype, device) -> dict:
    """Both warps' TPS noise and affine, then both jitters' factors."""
    g = generator(seed, step, device)
    n = aug["grid_size"] ** 2
    warps = []
    for _ in range(2):
        noise = torch.randn((batch, n, 2), generator=g,
                            device=device).clamp(-3.0, 3.0)
        theta = _uniform(g, (batch,), aug["rotate"])
        scale = 1.0 + _uniform(g, (batch, 1, 1), aug["scale"])
        trans = _uniform(g, (batch, 1, 2), aug["translate"])
        warps.append((noise, theta, scale, trans))
    jitters = []
    for _ in range(2):
        factors = []
        for name in ("brightness", "contrast", "saturation"):
            s = aug[name]
            if s <= 0 or (name == "saturation" and channels != 3):
                factors.append(None)
                continue
            u = torch.rand((batch, 1, 1, 1), generator=g, dtype=factor_dtype,
                           device=device)
            lo, hi = max(0.0, 1.0 - s), 1.0 + s
            # the factor as drawn: scaled and shifted in the draw's dtype
            factors.append((u * (hi - lo) + lo).float())
        jitters.append(factors)
    return {"warps": warps, "jitters": jitters}


def _sites(n: int) -> torch.Tensor:
    c = torch.linspace(-1.0, 1.0, n, dtype=torch.float64)
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([gx, gy], -1).reshape(-1, 2)


def _u(r2: torch.Tensor) -> torch.Tensor:
    return torch.where(r2 > 0, r2 * torch.log(r2.clamp_min(1e-300)),
                       torch.zeros_like(r2))


def tps_field(warp, aug: dict) -> torch.Tensor:
    """One warp's backward field at ``field_res``^2 points: (B, F, F, 2)."""
    noise, theta, scale, trans = (t.double() for t in warp)
    device = noise.device
    sites = _sites(aug["grid_size"]).to(device)
    t = sites + aug["tps_scale"] * noise
    cos, sin = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    x, y = t[..., 0], t[..., 1]
    t = torch.stack([cos * x - sin * y, sin * x + cos * y], -1) * scale + trans
    n = sites.shape[0]
    k = _u(((sites[:, None] - sites[None]) ** 2).sum(-1))
    p = torch.cat([torch.ones((n, 1), dtype=torch.float64, device=device),
                   sites], 1)
    system = torch.zeros((n + 3, n + 3), dtype=torch.float64, device=device)
    system[:n, :n], system[:n, n:], system[n:, :n] = k, p, p.T
    rhs = torch.cat([t, torch.zeros((t.shape[0], 3, 2), dtype=torch.float64,
                                    device=device)], 1)
    sol = torch.linalg.solve(system, rhs)                   # (B, n + 3, 2)
    f = aug["field_res"]
    c = torch.linspace(-1.0, 1.0, f, dtype=torch.float64, device=device)
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    q = torch.stack([gx, gy], -1).reshape(-1, 2)            # (F*F, 2)
    radial = _u(((q[:, None] - sites[None]) ** 2).sum(-1))  # (F*F, n)
    homo = torch.cat([torch.ones((q.shape[0], 1), dtype=torch.float64,
                                 device=device), q], 1)
    field = radial @ sol[:, :n] + homo @ sol[:, n:]
    return field.reshape(-1, f, f, 2).float()


def warp(images: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """Sample ``images`` at the field upsampled bilinearly to their size,
    bilinear, border padding, pixel centres at +-1."""
    h, w = images.shape[2:]
    grid = F.interpolate(field.permute(0, 3, 1, 2), size=(h, w),
                         mode="bilinear", align_corners=True)
    return F.grid_sample(images, grid.permute(0, 2, 3, 1), mode="bilinear",
                         padding_mode="border", align_corners=True)


def _gray(x: torch.Tensor) -> torch.Tensor:
    if x.shape[1] == 3:
        return x[:, :1] * LUMA[0] + x[:, 1:2] * LUMA[1] + x[:, 2:] * LUMA[2]
    return x.mean(1, keepdim=True)


def jitter(x: torch.Tensor, factors) -> torch.Tensor:
    brightness, contrast, saturation = factors
    if brightness is not None:
        x = x * brightness
    if contrast is not None:
        mean = _gray(x).mean((2, 3), keepdim=True)
        x = mean + (x - mean) * contrast
    if saturation is not None:
        gray = _gray(x)
        x = gray + (x - gray) * saturation
    return x.clamp(0.0, 1.0)


def make_pair(images: torch.Tensor, draws: dict, aug: dict, rows=None):
    """float32 images in [0, 1] -> (source, target), for the ``rows`` slice
    of the batch the draws were made for (all of it when None)."""
    out = []
    for w, j in zip(draws["warps"], draws["jitters"]):
        if rows is not None:
            w = tuple(t[rows] for t in w)
            j = [None if f is None else f[rows] for f in j]
        out.append(jitter(warp(images, tps_field(w, aug)), j))
    return out[0], out[1]
