"""The port's pair augmentation against the JAX package's (CPU).

``jax.random`` and torch never draw the same numbers, so the deterministic
half of each random function is fed what JAX drew: ``jax_warp_draws``,
``jax_jitter_factors`` and ``jax_pair_draws`` below repeat the key splits of
``random_warp_field``/``random_warp_grid``, ``color_jitter`` and
``keypoints_tpu.data.augment._warped_pair``, and the port's pair built from
them is held to JAX's ``make_pair`` on the same key. The port's own draws
get distribution checks. f32 on both sides: atol 1e-5 (summation order
only) unless a test says why not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keypoints_tpu.data import augment as jaug
from keypoints_tpu.kernels.warp_pallas import warp_bilinear_pallas
from keypoints_tpu.ops import warp as jwarp
from keypoints_tpu.ops.color import color_jitter as jax_color_jitter
from keypoints_tpu_torch.data import augment as aug
from keypoints_tpu_torch.ops import warp
from keypoints_tpu_torch.ops.color import (JitterFactors, apply_jitter,
                                           draw_jitter)

ATOL = 1e-5
CFG = aug.WarpConfig()


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def jax_warp_draws(key, batch: int, cfg=CFG) -> aug.WarpDraws:
    """The draws of JAX's random_warp_field / random_warp_grid on ``key``."""
    k_tps, k_rot, k_scale, k_trans = jax.random.split(key, 4)
    n = cfg.grid_size * cfg.grid_size
    noise = jnp.clip(jax.random.normal(k_tps, (batch, n, 2)), -3.0, 3.0)
    theta = jax.random.uniform(k_rot, (batch,), minval=-cfg.rotate,
                               maxval=cfg.rotate)
    scale = 1.0 + jax.random.uniform(k_scale, (batch, 1, 1),
                                     minval=-cfg.scale, maxval=cfg.scale)
    trans = jax.random.uniform(k_trans, (batch, 1, 2), minval=-cfg.translate,
                               maxval=cfg.translate)
    return aug.WarpDraws(_t(noise), _t(theta), _t(scale), _t(trans))


def jax_jitter_factors(key, batch: int, channels: int, cfg=CFG,
                       dtype=jnp.float32) -> JitterFactors:
    """The factors JAX's color_jitter draws on ``key`` (in ``dtype``, the
    dtype of the image it jitters)."""
    kb, kc, ks = jax.random.split(key, 3)

    def factor(k, s):
        return _t(jax.random.uniform(k, (batch, 1, 1, 1), dtype,
                                     max(0.0, 1.0 - s), 1.0 + s))
    return JitterFactors(factor(kb, cfg.brightness),
                         factor(kc, cfg.contrast),
                         factor(ks, cfg.saturation) if channels == 3
                         else None)


def jax_pair_draws(key, shape, cfg=CFG, jitter_dtype=jnp.float32
                   ) -> aug.PairDraws:
    """What JAX's make_pair(key, ...) draws for images of ``shape``: its two
    warps (coarse fields, or dense grids below field_res) and its jitter
    factors, by the key splits of ``_warped_pair``. JAX's CPU warp returns
    f32, so there its factors are f32 whatever the image."""
    b, c, h, w = shape
    ks, kt, kc_s, kc_t = jax.random.split(key, 4)

    def warp(k):
        if cfg.field_res < min(h, w):
            return _t(jaug.random_warp_field(k, b, cfg))
        return _t(jaug.random_warp_grid(k, b, h, w, cfg))
    return aug.PairDraws(warp(ks), warp(kt),
                         jax_jitter_factors(kc_s, b, c, cfg, jitter_dtype),
                         jax_jitter_factors(kc_t, b, c, cfg, jitter_dtype))


def _images(n, size, seed):
    return np.random.RandomState(seed).rand(n, 3, size, size).astype(
        np.float32)


def test_dense_warp_grid_from_jax_draws_matches_jax():
    """Below field_res (32² < 33) the warp is the exact dense TPS."""
    key = jax.random.PRNGKey(32)
    want = jaug.random_warp_grid(key, 3, 32, 32, CFG)
    got = aug.warp_grid(jax_warp_draws(key, 3), 32, 32, CFG)
    assert got.shape == (3, 32, 32, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _field_f64(d: aug.WarpDraws, cfg=CFG) -> np.ndarray:
    """The coarse field of ``d`` in float64 (a batched solve), the yardstick
    of both packages' f32 fields."""
    f64 = torch.float64
    sites = aug._control_grid(cfg.grid_size).to(f64)
    t = sites + cfg.tps_scale * d.noise.to(f64)
    c, s = torch.cos(d.theta.to(f64))[:, None], torch.sin(d.theta.to(f64))[:, None]
    t = (torch.stack([c * t[..., 0] - s * t[..., 1],
                      s * t[..., 0] + c * t[..., 1]], -1)
         * d.scale.to(f64) + d.trans.to(f64))
    sites = sites.expand(t.shape[0], *sites.shape)
    n = cfg.field_res
    return warp.tps_grid(sites, t, n, n).numpy()


def test_warp_field_from_jax_draws_matches_jax():
    """The field's f32 rounding error is JAX's own concern too: against a
    float64 evaluation JAX's f32 field is off by up to 2.3e-5 (20 keys of 8,
    measured), the port's by up to 6.2e-6. So the port is held to 1e-5 of
    float64 and to 3e-5 of JAX."""
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jaug.random_warp_field(key, 8, CFG))
        draws = jax_warp_draws(key, 8)
        got = aug.warp_field(draws, CFG).numpy()
        assert got.shape == (8, 33, 33, 2)
        np.testing.assert_allclose(got, _field_f64(draws), atol=ATOL)
        np.testing.assert_allclose(got, want, atol=3 * ATOL)


@pytest.mark.parametrize("align", [True, False])
def test_tps_grids_and_upsample_match_jax(align):
    rs = np.random.RandomState(4)
    sites = np.asarray(jaug._control_grid(4))
    targets = (sites + 0.05 * rs.randn(2, 16, 2)).astype(np.float32)
    fixed = warp.tps_grid_fixed(_t(sites), _t(targets), 9, 11,
                                align_corners=align)
    np.testing.assert_allclose(
        fixed.numpy(), np.asarray(jwarp.tps_grid_fixed(
            jnp.asarray(sites), jnp.asarray(targets), 9, 11,
            align_corners=align)), atol=ATOL)
    batched = np.broadcast_to(sites, (2, 16, 2)).copy()
    dense = warp.tps_grid(_t(batched), _t(targets), 9, 11,
                          align_corners=align)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(jwarp.tps_grid(
            jnp.asarray(batched), jnp.asarray(targets), 9, 11,
            align_corners=align)), atol=ATOL)
    np.testing.assert_allclose(dense.numpy(), fixed.numpy(), atol=ATOL)
    up = warp.upsample_field_aligned(fixed, 20, 37)
    np.testing.assert_allclose(
        up.numpy(), np.asarray(jwarp.upsample_field_aligned(
            jnp.asarray(fixed.numpy()), 20, 37)), atol=ATOL)


def test_fixed_sites_must_be_on_the_cpu_constant():
    sites = aug._control_grid(3)
    got = warp.tps_coefficients_fixed_sites(sites, torch.zeros((1, 9, 2)))
    assert got[0].shape == (1, 9, 2) and got[1].shape == (1, 3, 2)
    with pytest.raises(ValueError, match="CPU"):
        warp.tps_grid_fixed(sites.to("meta"), torch.zeros((1, 9, 2)), 4, 4)


@pytest.mark.parametrize("channels", [3, 1])
def test_color_jitter_with_jax_factors_matches_jax(channels):
    img = np.random.RandomState(5).rand(4, channels, 16, 16).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    want = jax_color_jitter(key, jnp.asarray(img), 0.2, 0.3, 0.4)
    cfg = CFG._replace(brightness=0.2, contrast=0.3, saturation=0.4)
    got = apply_jitter(torch.from_numpy(img),
                       jax_jitter_factors(key, 4, channels, cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("size", [32, 64, 256],
                         ids=["32-dense", "64-field", "256-field"])
def test_pair_from_jax_draws_matches_jax_make_pair_f32(size):
    """256²: pose256's pair, whose warps go through ``warp_sample_field``
    (on CUDA the field kernel)."""
    img = _images(2, size, seed=6)
    key = jax.random.PRNGKey(6)
    src_j, tgt_j = jaug.make_pair(key, jnp.asarray(img), CFG)
    src, tgt = aug.pair_from_draws(torch.from_numpy(img),
                                   jax_pair_draws(key, img.shape), CFG)
    assert src.shape == tgt.shape == (2, 3, size, size)
    np.testing.assert_allclose(src.numpy(), np.asarray(src_j), atol=ATOL)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(tgt_j), atol=ATOL)


def _jax_bf16_pair(key, img_bf16, draws):
    """JAX's bf16 pair as its TPU path makes it: the Pallas warp (interpret
    mode) keeps the image's bf16, and the jitter runs in bf16 on bf16
    factors. (Its CPU path promotes the warp to f32, so it is no bf16.)"""
    _, _, h, w = img_bf16.shape
    ks, kt, kc_s, kc_t = jax.random.split(key, 4)
    out = []
    for warp_, kc in ((draws.source, kc_s), (draws.target, kc_t)):
        grid = jnp.asarray(warp_.numpy())
        if CFG.field_res < min(h, w):
            grid = jwarp.upsample_field_aligned(grid, h, w)
        warped = warp_bilinear_pallas(img_bf16, grid, "border", True,
                                      interpret=True)
        out.append(jax_color_jitter(kc, warped, CFG.brightness,
                                    CFG.contrast, CFG.saturation))
    return out


@pytest.mark.parametrize("size", [32, 64], ids=["32-dense", "64-field"])
def test_pair_bf16_within_twice_jax_own_bf16_gap(size):
    """bf16 rounds at other places in the two frameworks, so no fixed bf16
    bar is honest: the port's bf16 pair may be at most twice as far from
    JAX's f32 pair as JAX's own bf16 pair is."""
    img = _images(2, size, seed=7)
    key = jax.random.PRNGKey(7)
    f32 = jaug.make_pair(key, jnp.asarray(img), CFG)
    draws = jax_pair_draws(key, img.shape, jitter_dtype=jnp.bfloat16)
    b16 = _jax_bf16_pair(key, jnp.asarray(img, jnp.bfloat16), draws)
    draws = draws._replace(**{
        k: JitterFactors(*(f.to(torch.bfloat16) for f in getattr(draws, k)))
        for k in ("source_jitter", "target_jitter")})
    port = aug.pair_from_draws(torch.from_numpy(img).to(torch.bfloat16),
                               draws, CFG)
    for got, ref, jb in zip(port, f32, b16):
        assert got.dtype == torch.bfloat16 and jb.dtype == jnp.bfloat16
        jax_gap = float(np.abs(np.asarray(jb, np.float32)
                               - np.asarray(ref)).max())
        port_gap = float(np.abs(got.float().numpy() - np.asarray(ref)).max())
        assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)


def test_own_draws_are_in_range():
    gen = torch.Generator().manual_seed(0)
    cfg = CFG._replace(tps_scale=1.0)       # many clipped noise values
    for w in (aug.draw_warp(gen, 2000, cfg), aug.draw_warp(gen, 2000, cfg)):
        assert w.noise.shape == (2000, 25, 2)
        assert w.noise.abs().max() <= 3.0 and (w.noise.abs() == 3.0).any()
        assert w.theta.abs().max() <= cfg.rotate
        assert ((w.scale - 1.0).abs().max() <= cfg.scale)
        assert w.trans.abs().max() <= cfg.translate
        assert w.theta.std() > 0.5 * cfg.rotate / np.sqrt(3)
    d = aug.draw_pair(gen, (2000, 3, 64, 64), cfg)
    assert d.source.shape == d.target.shape == (2000, 33, 33, 2)
    for j in (d.source_jitter, d.target_jitter):
        for f, s in zip(j, (cfg.brightness, cfg.contrast, cfg.saturation)):
            assert f.shape == (2000, 1, 1, 1)
            assert f.min() >= 1.0 - s and f.max() <= 1.0 + s
    gray = draw_jitter(gen, 8, 1, 0.2, 0.2, 0.2, torch.bfloat16)
    assert gray.saturation is None and gray.brightness.dtype == torch.bfloat16


def test_make_pair_is_a_function_of_the_generator_seed():
    img = torch.from_numpy(_images(2, 64, seed=8))
    a = aug.make_pair(torch.Generator().manual_seed(1), img, CFG)
    b = aug.make_pair(torch.Generator().manual_seed(1), img, CFG)
    c = aug.make_pair(torch.Generator().manual_seed(2), img, CFG)
    for x, y, z in zip(a, b, c):
        assert x.shape == (2, 3, 64, 64) and torch.isfinite(x).all()
        assert x.min() >= 0.0 and x.max() <= 1.0
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert (x - z).abs().max() > 1e-2
