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


# --- the training slice's kernels: the plain versions against JAX ----------

import jax  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from keypoints_tpu.kernels.gaussian_pallas import gaussian_maps_pallas  # noqa: E402
from keypoints_tpu.kernels.warp_pallas import warp_bilinear_pallas  # noqa: E402
from keypoints_tpu.ops.gaussian import gaussian_maps as jax_gaussian  # noqa: E402
from keypoints_tpu.ops.warp import grid_sample as jax_grid_sample  # noqa: E402
from keypoints_tpu_torch.kernels import extract_and_render  # noqa: E402
from keypoints_tpu_torch.kernels import gaussian_maps as gaussian_dispatch  # noqa: E402
from keypoints_tpu_torch.kernels import warp_sample  # noqa: E402
from keypoints_tpu_torch.ops.gaussian import gaussian_maps  # noqa: E402
from keypoints_tpu_torch.ops.warp import grid_sample  # noqa: E402


def _warp_inputs(shape, out_hw, seed):
    rs = np.random.RandomState(seed)
    img = rs.rand(*shape).astype(np.float32)
    # out-of-image points included: the grid spans [-1.2, 1.2]
    grid = (rs.rand(shape[0], *out_hw, 2) * 2.4 - 1.2).astype(np.float32)
    return img, grid


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("align", [True, False])
def test_plain_warp_matches_pallas_and_grid_sample(padding, align):
    img, grid = _warp_inputs((2, 3, 32, 48), (24, 40), seed=11)
    got = grid_sample(torch.from_numpy(img), torch.from_numpy(grid), padding,
                      align)
    pallas = warp_bilinear_pallas(jnp.asarray(img), jnp.asarray(grid),
                                  padding, align, interpret=True)
    torch_ref = F.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                              "bilinear", padding, align)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 24, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), torch_ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_plain_warp_ragged_matches_jax(mode, padding):
    """The ragged case of the CUDA tests (2x3x13x29 -> 11x17), every mode."""
    img, grid = _warp_inputs((2, 3, 13, 29), (11, 17), seed=12)
    for align in (True, False):
        got = grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                          padding, align, mode).numpy()
        want = jax_grid_sample(jnp.asarray(img), jnp.asarray(grid), padding,
                               align, mode)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_plain_warp_keeps_bf16_and_rounds_once():
    img, grid = _warp_inputs((2, 3, 16, 16), (8, 8), seed=13)
    x = torch.from_numpy(img).to(torch.bfloat16)
    got = grid_sample(x, torch.from_numpy(grid), "border", True)
    want = grid_sample(x.float(), torch.from_numpy(grid), "border", True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(warp_sample(x, torch.from_numpy(grid),
                                           "border", True), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("align", [True, False])
def test_plain_gaussian_and_grad_match_pallas(align):
    rs = np.random.RandomState(14)
    kp = (rs.rand(2, 5, 2) * 2.2 - 1.1).astype(np.float32)
    g = rs.randn(2, 5, 16, 12).astype(np.float32)
    x = torch.from_numpy(kp).requires_grad_(True)
    maps = gaussian_maps(x, 16, 12, 0.15, align)
    (maps * torch.from_numpy(g)).sum().backward()
    pallas, vjp = jax.vjp(lambda k: gaussian_maps_pallas(
        k, 16, 12, 0.15, align, interpret=True), jnp.asarray(kp))
    np.testing.assert_allclose(maps.detach().numpy(), np.asarray(pallas),
                               atol=ATOL)
    np.testing.assert_allclose(
        maps.detach().numpy(),
        np.asarray(jax_gaussian(jnp.asarray(kp), 16, 12, 0.15, align)),
        atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), atol=ATOL)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["joint", "marginal"])
def test_plain_softmax_grad_matches_pallas(variant, align):
    hm = _heatmaps((2, 3, 16, 12), seed=15)
    g = np.random.RandomState(16).randn(2, 3, 2).astype(np.float32)
    x = torch.from_numpy(hm).requires_grad_(True)
    (spatial_softmax(x, 0.7, variant, align) * torch.from_numpy(g)).sum() \
        .backward()
    _, vjp = jax.vjp(lambda h: spatial_softmax_pallas(
        h, 0.7, variant, align, interpret=True), jnp.asarray(hm))
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), atol=ATOL)


def test_cpu_dispatchers_keep_the_gradient():
    """On the CPU the dispatchers are the plain versions, so autograd runs
    through them: keypoints and maps carry a grad_fn, and the bottleneck's
    gradient reaches the heatmaps."""
    hm = torch.from_numpy(_heatmaps((2, 3, 8, 8), seed=17)).requires_grad_()
    kp = dispatch(hm, 1.0, "marginal", True)
    assert kp.grad_fn is not None
    maps = gaussian_dispatch(kp, 8, 8, 0.1, True)
    assert maps.grad_fn is not None
    kp2, maps2 = extract_and_render(hm, 8, 8, 1.0, 0.1, "marginal", True)
    torch.testing.assert_close(kp2, kp, rtol=0, atol=0)
    torch.testing.assert_close(maps2, maps, rtol=0, atol=0)
    maps2.sum().backward()
    assert hm.grad is not None and torch.isfinite(hm.grad).all()
    assert hm.grad.abs().sum() > 0


# --- the pose256 slice's kernels: the plain versions against JAX --------------

from keypoints_tpu.data.augment import WarpConfig as JaxWarpConfig  # noqa: E402
from keypoints_tpu.data.augment import \
    random_warp_field as jax_random_warp_field  # noqa: E402
from keypoints_tpu.kernels.pool_pallas import max_pool_2x2_pallas  # noqa: E402
from keypoints_tpu.kernels.warp_pallas import warp_field_pallas  # noqa: E402
from keypoints_tpu.models.vgg import max_pool_2x2 as jax_max_pool  # noqa: E402
from keypoints_tpu_torch.kernels import max_pool_2x2 as pool_dispatch  # noqa: E402
from keypoints_tpu_torch.kernels import warp_sample_field  # noqa: E402
from keypoints_tpu_torch.ops.pool import max_pool_2x2  # noqa: E402


def _pool_inputs(kind, shape, seed):
    """NCHW inputs: smooth values, or plateaus (quantised values with ReLU
    zeros, so most windows hold ties); and a gradient for the output."""
    rs = np.random.RandomState(seed)
    n, c, h, w = shape
    if kind == "smooth":
        x = rs.randn(*shape)
    else:
        x = np.maximum(rs.randint(-2, 4, size=shape), 0) * 0.5
    g = rs.randn(n, c, h // 2, w // 2)
    return x.astype(np.float32), g.astype(np.float32)


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def _bits(a) -> np.ndarray:
    """float32 view of a bf16 or f32 array/tensor (exact)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("kind", ["smooth", "plateaus"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 8, 12), (3, 4, 6, 16)],
                         ids=["2x5x8x12", "3x4x6x16"])
def test_plain_pool_and_grad_match_jax_and_pallas_bitwise(shape, dtype, kind):
    """Forward and the first-maximum gradient equal, bit for bit, to JAX's
    reduce-window pool (select-and-scatter gradient) and to the Pallas pool
    in interpret mode; NCHW here, NHWC there."""
    x, g = _pool_inputs(kind, shape, seed=18)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = max_pool_2x2(xt)
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == tdt and y.shape == (shape[0], shape[1], shape[2] // 2,
                                          shape[3] // 2)
    xj, gj = jnp.asarray(_nhwc(x), jdt), jnp.asarray(_nhwc(g), jdt)
    for pool in (jax_max_pool, lambda v: max_pool_2x2_pallas(v, True)):
        yj, vjp = jax.vjp(pool, xj)
        (dj,) = vjp(gj)
        np.testing.assert_array_equal(_nhwc(_bits(y.detach())), _bits(yj))
        np.testing.assert_array_equal(_nhwc(_bits(xt.grad)), _bits(dj))


def test_pool_dispatcher_on_cpu_is_the_plain_pool():
    x, g = _pool_inputs("plateaus", (2, 3, 4, 6), seed=19)
    a = torch.from_numpy(x).requires_grad_(True)
    b = torch.from_numpy(x).requires_grad_(True)
    pool_dispatch(a).backward(torch.from_numpy(g))
    max_pool_2x2(b).backward(torch.from_numpy(g))
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    torch.testing.assert_close(
        a.grad, torch.autograd.grad(F.max_pool2d(b, 2, 2), b,
                                    torch.from_numpy(g))[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="even"):
        max_pool_2x2(torch.zeros((1, 1, 3, 4)))


@pytest.mark.parametrize("case,tol", [((3, 64, "zeros"), 1e-5),
                                      ((3, 64, "border"), 1e-5),
                                      ((1, 256, "border"), 1e-4)],
                         ids=["3x64-zeros", "3x64-border", "1x256-border"])
def test_field_warp_on_cpu_matches_pallas_field_kernel(case, tol):
    """``warp_sample_field`` on CPU tensors (upsample + plain warp) against
    the TPU field kernel in interpret mode, with no y_window. 1e-4 at 256²:
    the Pallas kernel lerps the field W first, the upsample H first (JAX's
    own test_warp_field_windowed_and_wide allows the same)."""
    b, size, padding = case
    img = np.random.RandomState(20).rand(b, 3, size, size).astype(np.float32)
    field = jax_random_warp_field(jax.random.PRNGKey(20), b, JaxWarpConfig())
    want = warp_field_pallas(jnp.asarray(img), field, size, size, padding,
                             True, interpret=True)
    got = warp_sample_field(torch.from_numpy(img),
                            torch.from_numpy(np.array(field)), size, size,
                            padding, True)
    assert got.shape == (b, 3, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)
