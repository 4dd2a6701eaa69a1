"""Device-side paired-frame synthesis: random TPS + affine warps + color jitter.

Port of ``keypoints_tpu/data/augment.py``. One image batch becomes a
(source, target) training pair by two independent random warps on the
device, each followed by per-example color jitter:

* a ``grid_size x grid_size`` TPS control grid is perturbed with Gaussian
  noise of std ``tps_scale`` (clipped to ±3σ, as in JAX),
* composed with a random affine (rotation, isotropic scale, translation),
* the backward sampling grid is evaluated (a coarse ``field_res`` field
  when ``field_res`` is below the image size, else the exact dense TPS)
  and the image is bilinearly sampled at it with border padding: the field
  through ``kernels.warp_sample_field`` (on CUDA the field kernel K5 at
  every size; the JAX package sends warps at most 128 wide to the upsample
  and its dense warp, a rule timed on a TPU that the H100's timings
  overturn: ``warp_sample_field``'s docstring), the dense grid through
  ``kernels.warp_sample``,
* then ``ops.color`` jitter.

Every random function is split in two: a draw step that takes a
``torch.Generator`` and draws on its device (``draw_warp``: the TPS noise
and the affine; ``draw_jitter``: the color factors), and a deterministic
step that takes the draws (``warp_field``/``warp_grid``; ``apply_jitter``).
A pair's draws (``PairDraws``: its two warps and two sets of factors) go
to ``pair_from_draws``, or to ``pair_with_positions_from_draws``, which also
carries ground-truth landmarks into the target (the eval set's pairs;
``make_pair_with_positions`` draws them). ``jax.random`` and torch never
give the same numbers, so the tests hand the deterministic steps what JAX
drew and compare with JAX's pair; the port's own draws get distribution
checks.

Not ported: ``warp_y_window``, ``window_checks`` and ``_check_window``. They
bound and assert the band of source rows the TPU warp keeps in VMEM, and the
CUDA warp reads any row.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS, axis_coords
from keypoints_tpu_torch.kernels import warp_sample, warp_sample_field
from keypoints_tpu_torch.ops.color import JitterFactors, apply_jitter, draw_jitter
from keypoints_tpu_torch.ops.warp import (invert_warp_at, tps_grid,
                                          tps_grid_fixed,
                                          upsample_field_aligned)


class WarpConfig(NamedTuple):
    grid_size: int = 5          # TPS control grid is grid_size^2 points
    tps_scale: float = 0.05     # std of control-point perturbation
    field_res: int = 33         # TPS field eval resolution (upsampled to the
                                # image; 0 = exact dense eval)
    rotate: float = 0.1         # max |rotation| in radians
    scale: float = 0.1          # max |log-ish scale delta|
    translate: float = 0.1      # max |translation| in normalized units
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2


class WarpDraws(NamedTuple):
    """The random numbers of one TPS∘affine warp of a batch of B."""
    noise: torch.Tensor   # (B, n, 2) standard normal clipped to ±3
    theta: torch.Tensor   # (B,) rotation, U[-rotate, rotate]
    scale: torch.Tensor   # (B, 1, 1) 1 + U[-scale, scale]
    trans: torch.Tensor   # (B, 1, 2) U[-translate, translate]


class PairDraws(NamedTuple):
    """One pair's random warps and jitter factors.

    Each warp is what ``random_warp_field`` gives when the coarse-field
    branch applies (``field_res`` below the image size: a (B, F, F, 2)
    field), else what ``random_warp_grid`` gives (the dense (B, H, W, 2)
    TPS grid): the warp as JAX's ``_warped_pair`` computes it from its keys.
    """
    source: torch.Tensor
    target: torch.Tensor
    source_jitter: JitterFactors
    target_jitter: JitterFactors


def _control_grid(n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n*n, 2) identity control sites spanning [-1, 1]^2, (x, y) order, on
    the CPU (a constant)."""
    c = axis_coords(n, align_corners=True, dtype=dtype)
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)


@functools.lru_cache(maxsize=8)
def _sites_on(n: int, device: str) -> torch.Tensor:
    """``_control_grid(n)`` kept on ``device``, copied there once."""
    return _control_grid(n).to(device)


def _uniform(generator: torch.Generator, shape: tuple, bound: float
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2.0 * bound) - bound


def draw_warp(generator: torch.Generator, batch: int,
              cfg: WarpConfig = WarpConfig()) -> WarpDraws:
    """Draw one warp of ``batch`` images on ``generator``'s device."""
    n = cfg.grid_size * cfg.grid_size
    noise = torch.randn((batch, n, 2), generator=generator,
                        device=generator.device).clamp(-3.0, 3.0)
    return WarpDraws(noise, _uniform(generator, (batch,), cfg.rotate),
                     1.0 + _uniform(generator, (batch, 1, 1), cfg.scale),
                     _uniform(generator, (batch, 1, 2), cfg.translate))


def warp_targets(draws: WarpDraws, cfg: WarpConfig = WarpConfig()
                 ) -> torch.Tensor:
    """Where each control site samples from in the source image, (B, n, 2):
    identity + noise, then the affine (rotate, scale, translate)."""
    t = (_sites_on(cfg.grid_size, str(draws.noise.device))
         + cfg.tps_scale * draws.noise)
    cos = torch.cos(draws.theta)[:, None]
    sin = torch.sin(draws.theta)[:, None]
    x, y = t[..., 0], t[..., 1]
    rotated = torch.stack([cos * x + (-sin) * y, sin * x + cos * y], dim=-1)
    return rotated * draws.scale + draws.trans


def warp_field(draws: WarpDraws, cfg: WarpConfig = WarpConfig(),
               align_corners: bool = DEFAULT_ALIGN_CORNERS) -> torch.Tensor:
    """The warp as a coarse field (B, field_res, field_res, 2): fixed-sites
    TPS, whose constants are computed once per device."""
    return tps_grid_fixed(_control_grid(cfg.grid_size),
                          warp_targets(draws, cfg), cfg.field_res,
                          cfg.field_res, align_corners=align_corners)


def _use_field(cfg: WarpConfig, height: int, width: int) -> bool:
    return bool(cfg.field_res) and cfg.field_res < min(height, width)


def warp_grid(draws: WarpDraws, height: int, width: int,
              cfg: WarpConfig = WarpConfig(),
              align_corners: bool = DEFAULT_ALIGN_CORNERS) -> torch.Tensor:
    """The warp's backward sampling grid (B, H, W, 2): the upsampled coarse
    field when ``field_res`` is below the image size, else the exact dense
    TPS (one batched solve)."""
    if _use_field(cfg, height, width):
        return upsample_field_aligned(warp_field(draws, cfg, align_corners),
                                      height, width)
    sites = _sites_on(cfg.grid_size, str(draws.noise.device))
    sites = sites.expand(draws.noise.shape[0], *sites.shape)
    return tps_grid(sites, warp_targets(draws, cfg), height, width,
                    align_corners=align_corners)


def random_warp_field(generator: torch.Generator, batch: int,
                      cfg: WarpConfig = WarpConfig(),
                      align_corners: bool = DEFAULT_ALIGN_CORNERS
                      ) -> torch.Tensor:
    """Random TPS∘affine warp as a coarse field (B, field_res, field_res, 2)."""
    return warp_field(draw_warp(generator, batch, cfg), cfg, align_corners)


def random_warp_grid(generator: torch.Generator, batch: int, height: int,
                     width: int, cfg: WarpConfig = WarpConfig(),
                     align_corners: bool = DEFAULT_ALIGN_CORNERS
                     ) -> torch.Tensor:
    """Random TPS∘affine backward sampling grid, (B, H, W, 2)."""
    return warp_grid(draw_warp(generator, batch, cfg), height, width, cfg,
                     align_corners)


def random_warp(generator: torch.Generator, batch: int, height: int,
                width: int, cfg: WarpConfig = WarpConfig(),
                align_corners: bool = DEFAULT_ALIGN_CORNERS) -> torch.Tensor:
    """One random warp of a (batch, ·, height, width) image as ``_warped_pair``
    uses it: the coarse field when ``field_res`` is below the image size,
    else the dense grid."""
    if _use_field(cfg, height, width):
        return random_warp_field(generator, batch, cfg, align_corners)
    return random_warp_grid(generator, batch, height, width, cfg,
                            align_corners)


def draw_pair(generator: torch.Generator, shape: tuple,
              cfg: WarpConfig = WarpConfig(),
              dtype: torch.dtype = torch.float32,
              align_corners: bool = DEFAULT_ALIGN_CORNERS) -> PairDraws:
    """Draw the warps and jitter factors of one pair of images of ``shape``
    (B, C, H, W) on ``generator``'s device; factors in ``dtype`` (the
    image's)."""
    b, c, h, w = shape

    def jitter():
        return draw_jitter(generator, b, c, cfg.brightness, cfg.contrast,
                           cfg.saturation, dtype)
    return PairDraws(random_warp(generator, b, h, w, cfg, align_corners),
                     random_warp(generator, b, h, w, cfg, align_corners),
                     jitter(), jitter())


def pair_from_draws(image: torch.Tensor, draws: PairDraws,
                    cfg: WarpConfig = WarpConfig(),
                    align_corners: bool = DEFAULT_ALIGN_CORNERS
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) → (source, target) from given warps and factors: the
    image is sampled at each warp with border padding (a coarse field
    through ``warp_sample_field``, a dense grid through ``warp_sample``;
    the CUDA warps on CUDA) and jittered. Deterministic; the pair has the
    image's dtype. This is JAX's ``_warped_pair`` after its draws."""
    _, _, h, w = image.shape
    out = []
    for warp, factors in ((draws.source, draws.source_jitter),
                          (draws.target, draws.target_jitter)):
        if _use_field(cfg, h, w):
            warped = warp_sample_field(image, warp, h, w,
                                       padding_mode="border",
                                       align_corners=align_corners)
        else:
            warped = warp_sample(image, warp, padding_mode="border",
                                 align_corners=align_corners)
        out.append(apply_jitter(warped, factors))
    return out[0], out[1]


def make_pair(generator: torch.Generator, image: torch.Tensor,
              cfg: WarpConfig = WarpConfig(),
              align_corners: bool = DEFAULT_ALIGN_CORNERS
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One image batch (B, C, H, W) → (source, target) independently warped
    pair, drawn on ``generator`` (which must live on the image's device)."""
    draws = draw_pair(generator, tuple(image.shape), cfg, image.dtype,
                      align_corners)
    return pair_from_draws(image, draws, cfg, align_corners)


def pair_with_positions_from_draws(image: torch.Tensor,
                                   positions: torch.Tensor, draws: PairDraws,
                                   cfg: WarpConfig = WarpConfig(),
                                   align_corners: bool = DEFAULT_ALIGN_CORNERS
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """:func:`pair_from_draws` that also carries ground-truth landmarks into
    the target: → (source, target, target_positions), ``positions`` (B, K,
    2 normalized (x, y) in ``image``) mapped to where they land in the
    warped target by fixed-point inversion of the target's field
    (``ops.warp.invert_warp_at``). Needs the coarse-field path (``field_res``
    below the image size), whose draws are fields."""
    _, _, h, w = image.shape
    if not _use_field(cfg, h, w):
        raise ValueError("make_pair_with_positions needs the coarse-field "
                         "warp path (cfg.field_res < image size)")
    src, tgt = pair_from_draws(image, draws, cfg, align_corners)
    return src, tgt, invert_warp_at(draws.target.float(), positions.float())


def make_pair_with_positions(generator: torch.Generator, image: torch.Tensor,
                             positions: torch.Tensor,
                             cfg: WarpConfig = WarpConfig(),
                             align_corners: bool = DEFAULT_ALIGN_CORNERS
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """:func:`make_pair` that also carries ``positions`` into the target:
    the pair's draws on ``generator``, then
    :func:`pair_with_positions_from_draws`. The eval set of a warp-mode
    preset is built with it, so locking is measured on the distribution
    the model trains on."""
    draws = draw_pair(generator, tuple(image.shape), cfg, image.dtype,
                      align_corners)
    return pair_with_positions_from_draws(image, positions, draws, cfg,
                                          align_corners)
