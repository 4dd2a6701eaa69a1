"""The port's plain soft-argmax against the JAX package's (CPU).

Same numpy inputs into ``keypoints_tpu.ops.spatial_softmax`` (the jnp path),
``spatial_softmax_pallas`` in interpret mode (the TPU kernel the port's CUDA
kernel replaces) and ``keypoints_tpu_torch.ops.spatial_softmax``. f32 on all
sides, so the tolerance is f32 summation order: atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keypoints_tpu.coords import axis_coords as jax_axis_coords
from keypoints_tpu.coords import coord_grid as jax_coord_grid
from keypoints_tpu.kernels.spatial_softmax_pallas import spatial_softmax_pallas
from keypoints_tpu.ops.spatial_softmax import spatial_softmax as jax_softmax
from keypoints_tpu_torch import coords
from keypoints_tpu_torch.kernels import spatial_softmax as dispatch
from keypoints_tpu_torch.ops.spatial_softmax import spatial_softmax

ATOL = 1e-5


def _heatmaps(shape, seed=0, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (1, 4, 13, 29)],
                         ids=["2x3x16x16", "1x4x13x29"])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["joint", "marginal"])
def test_plain_softmax_matches_jax_and_pallas(variant, align, temperature,
                                              shape):
    hm = _heatmaps(shape)
    got = spatial_softmax(torch.from_numpy(hm), temperature, variant,
                          align).numpy()
    want = np.asarray(jax_softmax(jnp.asarray(hm), temperature, variant,
                                  align))
    pallas = np.asarray(spatial_softmax_pallas(
        jnp.asarray(hm), temperature, variant, align, interpret=True))
    assert got.shape == shape[:2] + (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


@pytest.mark.parametrize("variant", ["joint", "marginal"])
def test_cpu_tensor_dispatches_to_plain(variant):
    hm = torch.from_numpy(_heatmaps((2, 3, 8, 12), seed=1))
    torch.testing.assert_close(dispatch(hm, 0.7, variant, False),
                               spatial_softmax(hm, 0.7, variant, False),
                               rtol=0, atol=0)


def test_flat_heatmap_centers():
    for variant in ("joint", "marginal"):
        kp = spatial_softmax(torch.zeros((1, 1, 8, 8)), 1.0, variant, True)
        np.testing.assert_allclose(kp.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("variant", ["joint", "marginal"])
def test_sharp_peak_at_boundary(variant):
    hm = np.full((1, 1, 16, 16), -30.0, np.float32)
    hm[0, 0, 0, 15] = 30.0                                  # top-right corner
    kp = spatial_softmax(torch.from_numpy(hm), 1.0, variant, True).numpy()
    np.testing.assert_allclose(kp[0, 0], [1.0, -1.0], atol=1e-4)
    pallas = np.asarray(spatial_softmax_pallas(jnp.asarray(hm), 1.0, variant,
                                               True, interpret=True))
    np.testing.assert_allclose(kp, pallas, atol=ATOL)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant"):
        spatial_softmax(torch.zeros((1, 1, 4, 4)), variant="mean")


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("n", [1, 2, 7, 32])
def test_coords_match_jax(n, align):
    np.testing.assert_allclose(coords.axis_coords(n, align).numpy(),
                               np.asarray(jax_axis_coords(n, align)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(coords.coord_grid(n, 5, align).numpy(),
                               np.asarray(jax_coord_grid(n, 5, align)),
                               rtol=0, atol=0)
    idx = torch.arange(n, dtype=torch.float32)
    np.testing.assert_allclose(coords.pixel_to_normalized(idx, n, align),
                               coords.axis_coords(n, align), atol=1e-6)
    if n > 1 or not align:     # one pixel with aligned corners maps to 0
        np.testing.assert_allclose(
            coords.normalized_to_pixel(coords.axis_coords(n, align), n,
                                       align), idx, atol=1e-5)
