"""The port's banded warps K7 and K8 against the JAX package's (CPU).

Mirrors ``tests/test_experimental_kernels.py``: the plain versions
(``keypoints_tpu_torch.ops.experimental``, the CPU path of
``keypoints_tpu_torch.kernels.experimental``) against ``jnp``
``grid_sample`` in f32 at that file's atol 2e-2, windowed and not; against
the Pallas kernels in interpret mode on the same bf16 inputs within one
bf16 ulp, with a window that holds (border padding) and one that is
violated (zeros padding: K7 by the alternating-rows grid, K8 by the same
grid transposed, which breaks its per-row window); and the argument
contract. Interpret mode is slow on a CPU, so each kernel runs it once per
padding, at 64². The CUDA kernels are held to these plain versions on the
card (``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 20).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keypoints_tpu.data.augment import (WarpConfig, random_warp_grid,
                                        warp_y_window)
from keypoints_tpu.kernels import experimental as jexp
from keypoints_tpu.ops.warp import grid_sample
from keypoints_tpu_torch.kernels import experimental as kexp
from keypoints_tpu_torch.ops import experimental as pexp
from keypoints_tpu_torch.testing import bf16_ulp, share_cpu_threads

share_cpu_threads()

CFG = WarpConfig()
KERNELS = {"tree": (kexp.warp_bilinear_tree, jexp.warp_bilinear_tree),
           "rowwin": (kexp.warp_bilinear_rowwin, jexp.warp_bilinear_rowwin)}
_jax_grid = jax.jit(random_warp_grid, static_argnums=(1, 2, 3, 4))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _within_ulp(got: torch.Tensor, want) -> None:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    diff = (got.float() - want).abs()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool((diff <= bf16_ulp(want)).all()), diff.max().item()


def _warp_case(seed: int):
    """JAX's test inputs: a 3x3x64² image and a random warp grid."""
    img = np.random.RandomState(seed).rand(3, 3, 64, 64).astype(np.float32)
    g = np.array(_jax_grid(jax.random.PRNGKey(seed), 3, 64, 64, CFG))
    return img, g, np.asarray(grid_sample(jnp.asarray(img), jnp.asarray(g),
                                          "zeros", True)), \
        np.asarray(grid_sample(jnp.asarray(img), jnp.asarray(g), "border",
                               True))


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_warp_rowwin_packed_matches_oracle(padding):
    """K8 at its window agrees with grid_sample to bf16 resolution; with
    border padding, also with the Pallas kernel within one bf16 ulp."""
    img, g, *want = _warp_case(21)
    win = warp_y_window(CFG, 64)
    got = kexp.warp_bilinear_rowwin(_bf16(img), torch.from_numpy(g),
                                    padding, True, y_window=win)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               want[padding == "border"], atol=2e-2)
    if padding == "border":
        _within_ulp(got, jexp.warp_bilinear_rowwin(
            jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(g), padding,
            True, y_window=win, interpret=True))


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_warp_tree_yselect_matches_oracle(padding):
    """K7 windowed and not agrees with grid_sample to bf16 resolution; with
    border padding and a band of 48 of the 64 rows, also with the Pallas
    kernel within one bf16 ulp."""
    img, g, *want = _warp_case(23)
    for win in (warp_y_window(CFG, 64), 16, None):
        got = kexp.warp_bilinear_tree(_bf16(img), torch.from_numpy(g),
                                      padding, True, y_window=win)
        np.testing.assert_allclose(got.float().numpy(),
                                   want[padding == "border"], atol=2e-2)
    assert pexp.tree_window(16, 64) == 48
    if padding == "border":
        got = kexp.warp_bilinear_tree(_bf16(img), torch.from_numpy(g),
                                      padding, True, y_window=16)
        _within_ulp(got, jexp.warp_bilinear_tree(
            jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(g), padding,
            True, y_window=16, interpret=True))


@pytest.mark.parametrize("kernel", ["tree", "rowwin"])
def test_violated_window_zero_fills_as_jax(kernel):
    """With the window violated, each kernel's samples past its band read
    as 0, as the Pallas kernel's do (K7: y alternates between -0.9 and 0.9
    from row to row, so every 8-row block spans the image; K8: the same
    grid transposed, so every row does), within one bf16 ulp of it."""
    img = (np.random.RandomState(29).rand(1, 3, 64, 64) * 0.8 + 0.1).astype(
        np.float32)
    xs = np.linspace(-0.9, 0.9, 64, dtype=np.float32)
    ys = np.where(np.arange(64) % 2 == 0, -0.9, 0.9).astype(np.float32)
    gx, gy = np.meshgrid(xs, ys)
    if kernel == "rowwin":
        gy = gy.T
    g = np.stack([gx, gy], -1)[None]
    port, jax_kernel = KERNELS[kernel]
    got = port(_bf16(img), torch.from_numpy(g), "zeros", True, y_window=16)
    _within_ulp(got, jax_kernel(jnp.asarray(img).astype(jnp.bfloat16),
                                jnp.asarray(g), "zeros", True, y_window=16,
                                interpret=True))
    past = got[..., 1::2] if kernel == "rowwin" else got[:, :, 1::2]
    assert bool((past == 0).all())
    assert bool((got[:, :, ::2, ::2] > 0.05).all())


def _edge_grid(b, ho, wo, span, seed):
    """A rotated, jittered grid whose output rows step through source y in
    [-span, span] (reaching past the image in x), so a band's window holds
    and some corners fall outside the image."""
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.linspace(-span, span, ho),
                         np.linspace(-1.05, 1.05, wo), indexing="ij")
    c, s = np.cos(0.1), np.sin(0.1)
    g = np.stack([c * xs - s * ys, s * xs + c * ys], -1)
    return (g + 0.005 * rs.randn(b, ho, wo, 2)).astype(np.float32)


# (image shape, Ho, Wo, y span, y_window): the CUDA kernels' launch geometry
# changes at these edges (one pixel a thread at odd Wo, a band of fewer than
# 32 pixel pairs, a single band, a single image)
EDGES = [((1, 3, 64, 48), 8, 21, 0.2, 16),
         ((2, 2, 48, 40), 16, 20, 0.3, 16),
         ((1, 3, 64, 64), 8, 36, 0.1, 8)]


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("kernel", ["tree", "rowwin"])
@pytest.mark.parametrize("case", EDGES,
                         ids=["odd-wo-ho8-b1", "wo20-b2", "one-band-b1"])
def test_edge_geometry_matches_jax(case, kernel, padding):
    """The plain K7/K8 at odd Wo, Wo < 32, Ho = 8 and B = 1 against the
    Pallas kernel in interpret mode within one bf16 ulp, and against jnp
    ``grid_sample`` at 2e-2 (the window holds)."""
    shape, ho, wo, span, y_window = case
    img = np.random.RandomState(41).rand(*shape).astype(np.float32)
    g = _edge_grid(shape[0], ho, wo, span, 42)
    port, jax_kernel = KERNELS[kernel]
    got = port(_bf16(img), torch.from_numpy(g), padding, True,
               y_window=y_window)
    assert got.shape == (shape[0], shape[1], ho, wo)
    _within_ulp(got, jax_kernel(jnp.asarray(img).astype(jnp.bfloat16),
                                jnp.asarray(g), padding, True,
                                y_window=y_window, interpret=True))
    want = grid_sample(jnp.asarray(img), jnp.asarray(g), padding, True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=2e-2)


BAD = [("tree", torch.float32, 64, 8, "zeros", "bf16"),
       ("tree", torch.bfloat16, 63, 8, "zeros", "multiple of 2"),
       ("rowwin", torch.bfloat16, 40, 8, "zeros", "multiple of 16"),
       ("tree", torch.bfloat16, 64, 7, "zeros", "multiple of 8"),
       ("rowwin", torch.bfloat16, 64, 12, "zeros", "multiple of 8"),
       ("tree", torch.bfloat16, 64, 8, "reflection", "padding_mode"),
       ("rowwin", torch.bfloat16, 64, 8, "reflection", "padding_mode")]


@pytest.mark.parametrize("kernel,dtype,h,ho,padding,message", BAD)
def test_argument_contract_raises(kernel, dtype, h, ho, padding, message):
    """What the JAX entries reject raises ValueError, on the CPU path as on
    the kernel's (they share the check); the JAX entries' lane limits (W,
    Wo ≤ 512 or 128, C ≤ 8) are not carried."""
    image = torch.zeros((1, 3, h, 32), dtype=dtype)
    grid = torch.zeros((1, ho, 16, 2))
    with pytest.raises(ValueError, match=message):
        KERNELS[kernel][0](image, grid, padding)


def test_lane_limits_are_not_carried():
    img = torch.rand(1, 9, 32, 640).to(torch.bfloat16)
    grid = torch.rand(1, 8, 600, 2) * 2 - 1
    for port, _ in KERNELS.values():
        assert port(img, grid, "border", True, 8).shape == (1, 9, 8, 600)
