"""The CUDA kernels against their plain PyTorch versions, on the GPU.

The soft-argmax forward and backward, the Gaussian raster forward and
backward, the fused bottleneck (soft-argmax then raster) with its composed
backward, the bilinear warps (dense grid and coarse field), the banded
warps K7 and K8, and the 2×2 max pool forward and backward; their dispatchers and autograd Functions;
launch counts; rejections; and a backward through the full autoencoder,
through the Transporter and through the VGG perceptual loss.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (a CUDA kernel has no CPU mode). The kernel is built with nvcc at
first use. On a GPU machine without JAX, run it without the suite's
conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.kernels import experimental as banded
from keypoints_tpu_torch.kernels import experimental_cuda as ecu
from keypoints_tpu_torch.kernels import fused_bottleneck_cuda as fbc
from keypoints_tpu_torch.kernels import gaussian_cuda as gc
from keypoints_tpu_torch.kernels import pool_cuda as pc
from keypoints_tpu_torch.kernels import spatial_softmax_cuda as ssc
from keypoints_tpu_torch.kernels import (extract_and_render, gaussian_maps,
                                         max_pool_2x2, spatial_softmax,
                                         warp_cuda, warp_sample,
                                         warp_sample_field)
from keypoints_tpu_torch.ops import experimental as plain_banded
from keypoints_tpu_torch.ops.fused_bottleneck import \
    softargmax_raster as plain_bottleneck
from keypoints_tpu_torch.ops.gaussian import gaussian_maps as plain_gaussian
from keypoints_tpu_torch.ops.pool import max_pool_2x2 as plain_pool
from keypoints_tpu_torch.ops.spatial_softmax import spatial_softmax as plain
from keypoints_tpu_torch.ops.warp import grid_sample as plain_warp
from keypoints_tpu_torch.ops.warp import upsample_field_aligned
from keypoints_tpu_torch.testing import (bf16_ulp, fused_grad_tolerance,
                                         fused_map_tolerance, random_images,
                                         share_cpu_threads,
                                         softmax_grad_tolerance)
from keypoints_tpu_torch.train import make_loss
from keypoints_tpu_torch.training import build_model

share_cpu_threads()

pytestmark = pytest.mark.cuda

TOL = 2e-5   # f32 on both sides; only the order of the sums differs
SHAPES = [(10, 32, 32), (2560, 32, 32), (10240, 32, 32), (40, 16, 16),
          (7, 13, 29),
          # the warp path's layouts: transporter_atari's N at 16^2 (2 loads a
          # lane), pose256's at 32^2 (8), H != W on both sides of 32 rows,
          # one row and one column, and ragged widths of several chunks
          (256, 16, 16), (2048, 32, 32), (3, 64, 16), (3, 16, 64), (2, 1, 64),
          (2, 64, 1), (5, 31, 33)]
# the same as (B, K, H, W)
LAYOUTS = [(1, 256, 16, 16), (1, 2048, 32, 32), (1, 3, 64, 16),
           (1, 3, 16, 64), (1, 2, 1, 64), (1, 2, 64, 1), (1, 5, 31, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    return torch.device("cuda")


def _heatmaps(b, k, h, w, device, seed=0):
    x = 3 * np.random.RandomState(seed).randn(b, k, h, w)
    return torch.from_numpy(x.astype(np.float32)).to(device)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["marginal", "joint"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, variant, align, temperature):
    n, h, w = shape
    x = _heatmaps(1, n, h, w, cuda)
    before = ssc.launches
    got = ssc.spatial_softmax_cuda(x, temperature, variant, align)
    torch.cuda.synchronize()
    assert ssc.launches == before + 1
    want = plain(x, temperature, variant, align)
    assert got.shape == (1, n, 2)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 64, 64),
                                   (2, 5, 1, 64), (2, 5, 64, 1),
                                   (3, 7, 33, 31), *LAYOUTS],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_kernel_edge_shapes(cuda, shape, variant):
    x = _heatmaps(*shape, cuda, seed=1)
    got = ssc.spatial_softmax_cuda(x, 1.3, variant, True)
    torch.cuda.synchronize()
    assert (got - plain(x, 1.3, variant, True)).abs().max().item() <= TOL


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_dispatcher_sends_cuda_tensors_to_the_kernel(cuda, variant):
    x = _heatmaps(4, 10, 32, 32, cuda, seed=2)
    before = ssc.launches
    got = spatial_softmax(x, 0.7, variant, False)
    torch.cuda.synchronize()
    assert ssc.launches == before + 1
    assert (got - plain(x, 0.7, variant, False)).abs().max().item() <= TOL


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_flat_centres_and_corner_peak_lands_on_corner(cuda, variant):
    flat = torch.zeros((1, 1, 8, 8), device=cuda)
    np.testing.assert_allclose(
        ssc.spatial_softmax_cuda(flat, 1.0, variant, True).cpu(), 0.0,
        atol=1e-6)
    hm = torch.full((1, 1, 16, 16), -30.0, device=cuda)
    hm[0, 0, 0, 15] = 30.0
    kp = ssc.spatial_softmax_cuda(hm, 1.0, variant, True).cpu()
    np.testing.assert_allclose(kp[0, 0], [1.0, -1.0], atol=1e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = _heatmaps(2, 3, 16, 16, cuda)
    with pytest.raises(ValueError, match="float32"):
        ssc.spatial_softmax_cuda(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        ssc.spatial_softmax_cuda(x.transpose(2, 3))
    # a side above 64 computes (the block-per-row kernel); only a marginal
    # heatmap whose H + W passes the shared-memory sums raises
    wide = _heatmaps(1, 1, 65, 8, cuda)
    for variant in ("marginal", "joint"):
        got = ssc.spatial_softmax_cuda(wide, 1.0, variant)
        torch.cuda.synchronize()
        assert (got - plain(wide, 1.0, variant)).abs().max().item() <= TOL
    with pytest.raises(ValueError, match="H \\+ W <= 4096"):
        ssc.spatial_softmax_cuda(_heatmaps(1, 1, 65, 4032, cuda))
    with pytest.raises(ValueError, match="variant"):
        ssc.spatial_softmax_cuda(x, variant="mean")


# heatmaps above 64 a side: the block-per-row kernels
WIDE = [(2, 3, 65, 65), (2, 3, 96, 96), (2, 3, 128, 128), (2, 3, 65, 200),
        (1, 2, 300, 7)]
WIDE_IDS = ["65x65", "96x96", "128x128", "65x200", "300x7"]


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["marginal", "joint"])
@pytest.mark.parametrize("shape", WIDE, ids=WIDE_IDS)
def test_wide_heatmaps_forward_and_backward_match_plain(cuda, shape, variant,
                                                        align):
    """K1 and K1b above 64 a side, through the dispatcher: one forward and
    one backward launch, the keypoints within TOL and dL/dheatmaps within
    ``testing.softmax_grad_tolerance`` of the plain version and its
    autograd; the backward twice gives the same bits (no float atomics)."""
    x = _heatmaps(*shape, cuda, seed=21).requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(22).randn(
        *shape[:2], 2).astype(np.float32)).to(cuda)
    fwd, bwd = ssc.launches, ssc.bwd_launches
    kp = spatial_softmax(x, 0.7, variant, align)
    (kp * g).sum().backward()
    torch.cuda.synchronize()
    assert (ssc.launches, ssc.bwd_launches) == (fwd + 1, bwd + 1)
    assert (kp - plain(x.detach(), 0.7, variant, align)).abs().max().item() \
        <= TOL
    want = _plain_grad(x.detach(), g, 0.7, variant, align)
    assert (x.grad - want).abs().max().item() <= \
        softmax_grad_tolerance(*shape[2:])
    again = ssc.spatial_softmax_bwd_cuda(x.detach(), kp.detach(), g, 0.7,
                                         variant, align)
    assert torch.equal(again, x.grad)


# --- soft-argmax backward (K1b) ----------------------------------------------

def _plain_grad(x, g, temperature, variant, align):
    x = x.clone().requires_grad_(True)
    (plain(x, temperature, variant, align) * g).sum().backward()
    return x.grad


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["marginal", "joint"])
@pytest.mark.parametrize("shape", [(128, 10, 32, 32), (1, 7, 13, 29),
                                   (2, 3, 64, 64), (3, 2, 1, 5), *LAYOUTS],
                         ids=lambda s: "x".join(map(str, s)))
def test_softmax_backward_matches_plain_autograd(cuda, shape, variant, align):
    """K1b within 1e-5 of the plain autograd; a second call gives the same
    bits (fixed-order reductions, no float atomics)."""
    x = _heatmaps(*shape, cuda, seed=3)
    g = torch.from_numpy(np.random.RandomState(4).randn(
        *shape[:2], 2).astype(np.float32)).to(cuda)
    kp = ssc.spatial_softmax_cuda(x, 0.7, variant, align)
    before = ssc.bwd_launches
    got = ssc.spatial_softmax_bwd_cuda(x, kp, g, 0.7, variant, align)
    again = ssc.spatial_softmax_bwd_cuda(x, kp, g, 0.7, variant, align)
    torch.cuda.synchronize()
    assert ssc.bwd_launches == before + 2
    want = _plain_grad(x, g, 0.7, variant, align)
    assert got.shape == x.shape
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", [(4, 10, 32, 32), (4, 4, 16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_unaligned_heatmaps_take_the_scalar_path(cuda, shape, variant):
    """A contiguous slice 4 bytes off a 16-byte boundary (the scalar-load
    layout of the warp path): K1 within TOL and K1b within 1e-5 of plain,
    two K1b calls equal, K3's keypoints equal to K1's bit for bit."""
    n = int(np.prod(shape))
    flat = _heatmaps(1, 1, 1, n + 1, cuda, seed=6).reshape(-1)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    kp = ssc.spatial_softmax_cuda(x, 0.7, variant, False)
    g = torch.from_numpy(np.random.RandomState(7).randn(
        *shape[:2], 2).astype(np.float32)).to(cuda)
    got = ssc.spatial_softmax_bwd_cuda(x, kp, g, 0.7, variant, False)
    again = ssc.spatial_softmax_bwd_cuda(x, kp, g, 0.7, variant, False)
    kp3, _ = fbc.softargmax_raster_cuda(x, 16, 16, 0.7, 0.1, False, variant)
    torch.cuda.synchronize()
    assert (kp - plain(x, 0.7, variant, False)).abs().max().item() <= TOL
    want = _plain_grad(x, g, 0.7, variant, False)
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got, again)
    assert torch.equal(kp3, kp)


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_dispatcher_keypoints_carry_the_kernel_gradient(cuda, variant):
    x = _heatmaps(4, 10, 32, 32, cuda, seed=5).requires_grad_(True)
    fwd, bwd = ssc.launches, ssc.bwd_launches
    kp = spatial_softmax(x, 1.0, variant, True)
    assert kp.grad_fn is not None
    g = torch.randn_like(kp)
    (kp * g).sum().backward()
    torch.cuda.synchronize()
    assert (ssc.launches, ssc.bwd_launches) == (fwd + 1, bwd + 1)
    want = _plain_grad(x.detach(), g, 1.0, variant, True)
    assert (x.grad - want).abs().max().item() <= 1e-5


# --- Gaussian raster (K2) -------------------------------------------------------

# sigma by shape: pose256's 16 keypoints at 0.05, the others at 0.1
RASTER_SIGMA = {(128, 16, 32, 32): 0.05}


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape", [(128, 10, 32, 32), (2, 3, 13, 29),
                                   (128, 16, 32, 32), (64, 4, 16, 16),
                                   (1, 1, 13, 29)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gaussian_forward_and_backward_match_plain(cuda, shape, align):
    """celeba128's, pose256's and transporter_atari's rasters and ragged
    ones (W % 4 != 0, N = 1): forward and backward against the plain
    version through the dispatcher; the backward kernel twice, equal bits."""
    b, k, h, w = shape
    sigma = RASTER_SIGMA.get(shape, 0.1)
    rs = np.random.RandomState(6)
    kp = torch.from_numpy((rs.rand(b, k, 2) * 2.2 - 1.1).astype(
        np.float32)).to(cuda)
    g = torch.from_numpy(rs.randn(b, k, h, w).astype(np.float32)).to(cuda)
    fwd, bwd = gc.launches, gc.bwd_launches
    x = kp.clone().requires_grad_(True)
    maps = gaussian_maps(x, h, w, sigma, align)
    assert maps.grad_fn is not None
    (maps * g).sum().backward()
    torch.cuda.synchronize()
    assert (gc.launches, gc.bwd_launches) == (fwd + 1, bwd + 1)
    ref = kp.clone().requires_grad_(True)
    want = plain_gaussian(ref, h, w, sigma, align)
    (want * g).sum().backward()
    assert (maps - want).abs().max().item() <= 1e-5
    # the sums over H*W run in another order: 1e-4 of the gradient's scale
    scale = ref.grad.abs().max().item()
    assert (x.grad - ref.grad).abs().max().item() <= 1e-4 * scale
    flat, gflat = kp.reshape(-1, 2), g.reshape(-1, h, w)
    assert torch.equal(gc.gaussian_bwd_cuda(flat, gflat, sigma, align),
                       gc.gaussian_bwd_cuda(flat, gflat, sigma, align))


# --- bilinear warp (K4) ----------------------------------------------------------

# (image shape, output Ho x Wo, grid span, share of NaN points)
WARP_CASES = [((128, 3, 128, 128), (128, 128), 1.2, 0.0),
              ((2, 3, 13, 29), (11, 17), 1.2, 0.0),
              # the dense route's shape (make_pair of images 32 wide)
              ((128, 3, 32, 32), (32, 32), 1.2, 0.0),
              # ragged tiles: Ho not a multiple of 32 (or 16) and Wo not
              # one of 64 (or 32), odd Wo over two tiles, Wo = 1
              ((1, 3, 40, 50), (45, 70), 1.2, 0.0),
              ((2, 3, 20, 24), (33, 65), 1.2, 0.0),
              ((2, 3, 16, 16), (37, 1), 1.2, 0.0),
              # points far outside the image; NaN points
              ((2, 3, 48, 40), (40, 72), 5.0, 0.0),
              ((2, 3, 64, 64), (64, 64), 1.2, 0.05),
              # more images than one grid dimension holds
              ((70000, 1, 2, 2), (2, 2), 1.2, 0.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("case", WARP_CASES,
                         ids=["b128-128", "ragged", "b128-32", "45x70", "33x65",
                              "37x1", "far", "nan", "b70000"])
def test_warp_matches_plain_and_grid_sample(cuda, case, padding, align,
                                            dtype):
    """K4 within f32 1e-5 of plain and of ``F.grid_sample`` (bf16: one bf16
    ulp of plain). A NaN point reads as one far
    outside the image, as the corner math takes it: 0 under zeros padding,
    the border under border padding (the plain version cannot index at
    NaN, and ``F.grid_sample`` gives NaN under zeros padding, so both are
    held to the grid with NaN replaced by -10)."""
    shape, out_hw, span, nan_share = case
    rs = np.random.RandomState(7)
    img = torch.from_numpy(rs.rand(*shape).astype(np.float32)).to(cuda)
    img = img.to(dtype)
    grid = torch.from_numpy(((rs.rand(shape[0], *out_hw, 2) * 2 - 1) * span)
                            .astype(np.float32))
    grid[torch.from_numpy(rs.rand(*grid.shape) < nan_share)] = float("nan")
    grid = grid.to(cuda)
    before = warp_cuda.launches
    got = warp_sample(img, grid, padding, align)
    torch.cuda.synchronize()
    assert warp_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], shape[1], *out_hw)
    far = torch.nan_to_num(grid, nan=-10.0)
    want = plain_warp(img, far, padding, align)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
        lib = F.grid_sample(img, far, "bilinear", padding, align)
        assert (got - lib).abs().max().item() <= 1e-5
    else:
        assert bool((err <= bf16_ulp(want)).all())


def test_warp_identity_grid_returns_the_image(cuda):
    from keypoints_tpu_torch.coords import coord_grid
    img = torch.rand((2, 3, 16, 16), device=cuda)
    ident = coord_grid(16, 16, device=cuda).expand(2, 16, 16, 2).contiguous()
    out = warp_cuda.warp_bilinear_cuda(img, ident, "border", True)
    assert (out - img).abs().max().item() <= 1e-5


# --- what the wrappers refuse ------------------------------------------------------

def test_new_wrappers_reject_what_they_do_not_take(cuda):
    img = torch.rand((2, 3, 8, 8), device=cuda)
    grid = torch.zeros((2, 4, 4, 2), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        warp_cuda.warp_bilinear_cuda(img.half(), grid)
    with pytest.raises(ValueError, match="contiguous"):
        warp_cuda.warp_bilinear_cuda(img.transpose(2, 3), grid)
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp_cuda.warp_bilinear_cuda(img.cpu(), grid)
    with pytest.raises(ValueError, match="padding_mode"):
        warp_cuda.warp_bilinear_cuda(img, grid, "reflection")
    with pytest.raises(ValueError, match="grid"):
        warp_cuda.warp_bilinear_cuda(img, grid[:1].contiguous())
    odd = torch.zeros(2 * 4 * 4 * 2 + 1, device=cuda)[1:].view(2, 4, 4, 2)
    with pytest.raises(ValueError, match="aligned"):
        warp_cuda.warp_bilinear_cuda(img, odd)
    kp = torch.zeros((6, 2), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        gc.gaussian_fwd_cuda(kp.double(), 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gc.gaussian_fwd_cuda(kp.cpu(), 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        gc.gaussian_bwd_cuda(kp, torch.zeros((6, 8, 8), device=cuda)
                             .transpose(1, 2))
    x = _heatmaps(2, 3, 8, 8, cuda)
    with pytest.raises(ValueError, match="keypoints"):
        ssc.spatial_softmax_bwd_cuda(x, torch.zeros((2, 3, 3), device=cuda),
                                     torch.zeros((2, 3, 2), device=cuda))


# --- the model on the card --------------------------------------------------------

def test_backward_through_forward_reaches_every_parameter(cuda):
    """Full-width celeba128 in bf16 compute: the loss's gradient reaches
    every (float32) parameter through the kernels (the marginal bottleneck
    through K3, its backward through the K2 backward and K1b) and is
    finite."""
    cfg = get_config("celeba128")
    model = build_model(cfg, cuda)
    x = torch.rand((2, 3, 128, 128), device=cuda)
    y = torch.rand((2, 3, 128, 128), device=cuda)

    def counts():
        return (fbc.launches, ssc.launches, ssc.bwd_launches, gc.launches,
                gc.bwd_launches)
    before = counts()
    recon, kp = model(x, y)
    ((recon - y) ** 2).mean().backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 0, 1, 0, 1)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert model.keynet.trunk.Conv_0.weight.grad.abs().sum().item() > 0


# --- field warp (K5) ---------------------------------------------------------------

def _zoom_shear(b, f, device):
    """A strong zoom with shear: each tile's source footprint is several
    times the tile, over the staging budget."""
    axis = torch.linspace(-1, 1, f, device=device)
    y, x = torch.meshgrid(axis, axis, indexing="ij")
    return torch.stack([4 * x + 1.5 * y, 4 * y], -1).expand(
        b, f, f, 2).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("case", [((16, 3, 256, 256), 33, (256, 256)),
                                  ((2, 3, 45, 61), 9, (37, 53)),
                                  ((3, 3, 20, 30), 33, (19, 23)),
                                  ((128, 3, 128, 128), 33, (128, 128)),
                                  ((2, 3, 64, 48), 33, (80, 36)),
                                  ((2, 3, 64, 64), 33, (64, 63)),
                                  ((2, 3, 40, 40), 2, (40, 40)),
                                  ((1, 3, 40, 40), warp_cuda.MAX_FIELD,
                                   (50, 70)),
                                  ((2, 3, 256, 256), "zoom", (256, 256)),
                                  ((1, 3, 40, 50), 9, (45, 70))],
                         ids=["b16-256", "ragged-F9", "ragged-F33", "b128-128",
                              "Ho-not-H", "Wo-odd", "F2", "F-max",
                              "zoom-shear", "45x70"])
def test_field_warp_matches_upsample_and_plain_warp(cuda, case, padding,
                                                     align, dtype):
    """The field kernel equals ``upsample_field_aligned`` + the dense-grid
    kernel (K4) bit for bit, its tiles staged in shared memory (the
    default) and with direct gathers (``stage_bytes=0``, the branch a tile
    over the budget takes; the zoom's tiles take it by default); and it is
    within the plain version's bars: f32 1e-4 (JAX's bar for its field
    kernel), bf16 one bf16 ulp."""
    shape, f, out_hw = case
    rs = np.random.RandomState(8)
    img = torch.from_numpy(rs.rand(*shape).astype(np.float32)).to(cuda)
    img = img.to(dtype)
    if f == "zoom":
        field = _zoom_shear(shape[0], 33, cuda)
    else:
        field = torch.from_numpy((rs.rand(shape[0], f, f, 2) * 2.4 - 1.2)
                                 .astype(np.float32)).to(cuda)
    grid = upsample_field_aligned(field, *out_hw).contiguous()
    k4 = warp_cuda.warp_bilinear_cuda(img, grid, padding, align)
    want = plain_warp(img, grid, padding, align)
    for stage in (None, 0):
        before = warp_cuda.field_launches
        got = warp_cuda.warp_field_cuda(img, field, *out_hw, padding, align,
                                        stage_bytes=stage)
        torch.cuda.synchronize()
        assert warp_cuda.field_launches == before + 1
        assert got.dtype == dtype and got.shape == (shape[0], 3, *out_hw)
        assert torch.equal(got, k4)
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-4
        else:
            assert bool((err <= bf16_ulp(want)).all())


@pytest.mark.parametrize("width", [256, 128, 34])
def test_warp_sample_field_routes_by_output_width(cuda, width):
    """Every CUDA field warp takes the field kernel, at celeba128's 128 and
    pose256's 256 wide as at any other width."""
    img = torch.rand((2, 3, width, width), device=cuda)
    field = torch.rand((2, 33, 33, 2), device=cuda) * 2 - 1
    before = (warp_cuda.field_launches, warp_cuda.launches)
    got = warp_sample_field(img, field, width, width, "border", True)
    torch.cuda.synchronize()
    assert (warp_cuda.field_launches, warp_cuda.launches) == (before[0] + 1,
                                                              before[1])
    want = plain_warp(img, upsample_field_aligned(field, width, width),
                      "border", True)
    assert (got - want).abs().max().item() <= 1e-4


# --- max pool (K6) -------------------------------------------------------------------

def _pool_case(kind, shape, device, seed=9):
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "smooth":
        x = torch.randn(shape, generator=gen, device=device)
    else:           # quantised values with ReLU zeros: most windows tied
        x = torch.randint(-2, 4, shape, generator=gen,
                          device=device).clamp_min(0) * 0.5
    g = torch.randn((*shape[:2], shape[2] // 2, shape[3] // 2),
                    generator=gen, device=device)
    return x, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["smooth", "ties"])
@pytest.mark.parametrize("shape", [(8, 64, 256, 256), (8, 128, 128, 128),
                                   (3, 5, 6, 10), (1, 1, 2, 2)],
                         ids=["pool1-b8", "pool2-b8", "ragged", "one"])
def test_pool_forward_and_backward_bitwise(cuda, shape, kind, dtype):
    """Forward and first-maximum backward equal, bit for bit, to the plain
    version and to F.max_pool2d and its gradient, through the dispatcher
    (the autograd Function: one launch of each kernel)."""
    x, g = _pool_case(kind, shape, cuda)
    x, g = x.to(dtype), g.to(dtype)
    fwd, bwd = pc.launches, pc.bwd_launches
    xk = x.clone().requires_grad_(True)
    y = max_pool_2x2(xk)
    y.backward(g)
    torch.cuda.synchronize()
    assert (pc.launches, pc.bwd_launches) == (fwd + 1, bwd + 1)
    for pool in (plain_pool, lambda t: F.max_pool2d(t, 2, 2)):
        xr = x.clone().requires_grad_(True)
        want = pool(xr)
        want.backward(g)
        assert torch.equal(y, want)
        assert torch.equal(xk.grad, xr.grad)


def test_pool_nan_is_the_maximum_as_in_torch(cuda):
    x = torch.tensor([[[[1.0, float("nan")], [3.0, float("nan")]],
                       [[2.0, 5.0], [5.0, -1.0]]]], device=cuda)
    x = x.reshape(1, 2, 2, 2)
    g = torch.tensor([[[[7.0]], [[9.0]]]], device=cuda)
    y = pc.max_pool_fwd_cuda(x)
    dx = pc.max_pool_bwd_cuda(x, g)
    assert torch.isnan(y[0, 0, 0, 0]) and y[0, 1, 0, 0].item() == 5.0
    assert dx[0, 0].flatten().tolist() == [0.0, 7.0, 0.0, 0.0]
    assert dx[0, 1].flatten().tolist() == [0.0, 9.0, 0.0, 0.0]


def test_pool_and_field_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.rand((2, 3, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="even"):
        pc.max_pool_fwd_cuda(torch.rand((2, 3, 7, 8), device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pc.max_pool_fwd_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        pc.max_pool_fwd_cuda(x.transpose(2, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pc.max_pool_fwd_cuda(x.cpu())
    odd = torch.empty(2 * 3 * 8 * 8 + 1, device=cuda)[1:].view(2, 3, 8, 8)
    with pytest.raises(ValueError, match="aligned"):
        pc.max_pool_fwd_cuda(odd)
    with pytest.raises(ValueError, match="grad"):
        pc.max_pool_bwd_cuda(x, torch.zeros((2, 3, 4, 3), device=cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        pc.max_pool_bwd_cuda(x.bfloat16(), torch.zeros((2, 3, 4, 4),
                                                       device=cuda))
    field = torch.zeros((2, 33, 33, 2), device=cuda)
    with pytest.raises(ValueError, match="field"):
        warp_cuda.warp_field_cuda(x, field[:1].contiguous(), 8, 8)
    with pytest.raises(ValueError, match="field"):
        warp_cuda.warp_field_cuda(x, torch.zeros((2, 1, 1, 2), device=cuda),
                                  8, 8)
    with pytest.raises(ValueError, match="padding_mode"):
        warp_cuda.warp_field_cuda(x, field, 8, 8, "reflection")
    big = torch.zeros((2, warp_cuda.MAX_FIELD + 1, warp_cuda.MAX_FIELD + 1, 2),
                      device=cuda)
    with pytest.raises(ValueError, match="field"):
        warp_cuda.warp_field_cuda(x, big, 8, 8)
    with pytest.raises(ValueError, match="stage_bytes"):
        warp_cuda.warp_field_cuda(x, field, 8, 8,
                                  stage_bytes=warp_cuda.MAX_STAGE_BYTES + 1)


# --- the VGG perceptual loss on the card -----------------------------------------

def test_perceptual_loss_on_the_card_matches_the_cpu(cuda):
    """pose256's loss with its seeded trunk, f32 with TF32 off: the card
    (CUDA pools) within 1e-5 relative of the CPU (plain pools), and its
    gradient in the reconstruction within 1e-6; two pool launches a pass
    and two backward launches."""
    cfg = get_config("pose256").override(**{
        "train.compute_dtype": "float32", "data.image_size": 64})
    a, b = random_images(2, cfg, 1), random_images(2, cfg, 2)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for device in ("cpu", "cuda"):
            x = torch.from_numpy(a).to(device).requires_grad_(True)
            fwd, bwd = pc.launches, pc.bwd_launches
            value = make_loss(cfg, device)(x, torch.from_numpy(b).to(device))
            value.backward()
            if device == "cuda":
                torch.cuda.synchronize()
                assert (pc.launches, pc.bwd_launches) == (fwd + 4, bwd + 2)
            out[device] = (value.item(), x.grad.cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 1e-6


# --- fused bottleneck (K3) --------------------------------------------------

BOTTLENECK = [((64, 4, 16, 16), (16, 16), 0.1),     # transporter_atari b64
              ((1, 7, 13, 29), (11, 17), 0.1),      # ragged, Ho, Wo != H, W
              ((128, 10, 32, 32), (32, 32), 0.1),   # joint celeba128 b128
              ((128, 16, 32, 32), (32, 32), 0.05),  # joint pose256 b128
              # the warp path's other layouts: several chunks (64^2), ragged
              # widths of several chunks, one column of 2 loads a lane
              ((2, 3, 64, 64), (64, 64), 0.1),
              ((1, 5, 31, 33), (31, 33), 0.1),
              ((2, 5, 64, 1), (16, 4), 0.1),
              # the output sizes the map writing branches on: Wo % 4 != 0
              # with Ho * Wo odd (pixel by pixel), Wo < 4, float4 runs of a
              # 16-wide map from 32^2 heatmaps
              ((2, 5, 16, 16), (7, 13), 0.1),
              ((2, 5, 13, 29), (5, 3), 0.1),
              ((4, 10, 32, 32), (16, 16), 0.1)]


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["marginal", "joint"])
@pytest.mark.parametrize("case", BOTTLENECK,
                         ids=["atari-b64", "ragged", "celeba-b128",
                              "pose-b128", "64x64", "31x33", "64x1",
                              "7x13-maps", "5x3-maps", "16x16-maps"])
def test_fused_bottleneck_matches_plain_and_the_unfused_kernels(
        cuda, case, variant, align):
    """K3 against ``ops.fused_bottleneck``: keypoints within TOL, maps
    within ``testing.fused_map_tolerance``; and against K1 then K2 on the
    same heatmaps: keypoints and maps equal bit for bit (the same row
    functions and pixel formula)."""
    shape, (ho, wo), sigma = case
    x = _heatmaps(*shape, cuda, seed=10)
    before = fbc.launches
    kp, maps = fbc.softargmax_raster_cuda(x, ho, wo, 0.7, sigma, align,
                                          variant)
    torch.cuda.synchronize()
    assert fbc.launches == before + 1
    assert kp.shape == (*shape[:2], 2) and maps.shape == (*shape[:2], ho, wo)
    kp_p, maps_p = plain_bottleneck(x, ho, wo, 0.7, sigma, align, variant)
    assert (kp - kp_p).abs().max().item() <= TOL
    assert (maps - maps_p).abs().max().item() <= fused_map_tolerance(sigma)
    kp1 = ssc.spatial_softmax_cuda(x, 0.7, variant, align)
    maps2 = gc.gaussian_fwd_cuda(kp1.reshape(-1, 2), ho, wo, sigma, align)
    assert torch.equal(kp, kp1)
    assert torch.equal(maps, maps2.reshape(maps.shape))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["marginal", "joint"])
@pytest.mark.parametrize("case", BOTTLENECK[:3],
                         ids=["atari-b64", "ragged", "celeba-b128"])
def test_fused_bottleneck_backward_matches_plain_autograd(cuda, case,
                                                          variant, align):
    """``SoftargmaxRasterFused``'s dL/dheatmaps for random dL/dkeypoints
    and dL/dmaps: one K3, one K2 backward and one K1b launch, no K1 or K2
    forward; within ``testing.fused_grad_tolerance``."""
    shape, (ho, wo), sigma = case
    x = _heatmaps(*shape, cuda, seed=11).requires_grad_(True)
    rs = np.random.RandomState(12)
    g_kp = torch.from_numpy(rs.randn(*shape[:2], 2).astype(np.float32))
    g_maps = torch.from_numpy(rs.randn(*shape[:2], ho, wo).astype(np.float32))
    g_kp, g_maps = g_kp.to(cuda), g_maps.to(cuda)
    counts = (fbc.launches, gc.bwd_launches, ssc.bwd_launches, ssc.launches,
              gc.launches)
    kp, maps = fbc.softargmax_raster_autograd(x, ho, wo, 0.7, sigma, align,
                                              variant)
    assert kp.grad_fn is not None and maps.grad_fn is not None
    torch.autograd.backward((kp, maps), (g_kp, g_maps))
    torch.cuda.synchronize()
    assert (fbc.launches, gc.bwd_launches, ssc.bwd_launches, ssc.launches,
            gc.launches) == (counts[0] + 1, counts[1] + 1, counts[2] + 1,
                             counts[3], counts[4])
    xr = x.detach().clone().requires_grad_(True)
    torch.autograd.backward(plain_bottleneck(xr, ho, wo, 0.7, sigma, align,
                                             variant), (g_kp, g_maps))
    tol = fused_grad_tolerance(x, ho, wo, 0.7, sigma, align, variant, g_kp,
                               g_maps)
    assert bool(((x.grad - xr.grad).abs() <= tol).all())


WIDE_BOTTLENECK = [((2, 3, 65, 65), (65, 65), 0.1),
                   ((2, 3, 96, 96), (48, 48), 0.1),
                   ((4, 5, 128, 128), (128, 128), 0.05),
                   ((2, 3, 65, 200), (33, 100), 0.1),
                   # pixel by pixel: Wo % 4 != 0, Wo < 4
                   ((2, 3, 65, 65), (7, 13), 0.1),
                   ((2, 3, 70, 96), (5, 3), 0.05)]


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["marginal", "joint"])
@pytest.mark.parametrize("case", WIDE_BOTTLENECK,
                         ids=["65x65", "96x96", "128x128", "65x200",
                              "7x13-maps", "5x3-maps"])
def test_wide_fused_bottleneck_matches_plain_and_the_unfused_kernels(
        cuda, case, variant, align):
    """K3 above 64 a side (the block-per-heatmap kernel): keypoints within
    TOL and maps within ``testing.fused_map_tolerance`` of plain, both
    equal to K1 then K2 bit for bit; its composed backward (K2 bwd then
    K1b) within ``testing.fused_grad_tolerance`` of the plain autograd."""
    shape, (ho, wo), sigma = case
    x = _heatmaps(*shape, cuda, seed=23)
    kp, maps = fbc.softargmax_raster_cuda(x, ho, wo, 0.7, sigma, align,
                                          variant)
    torch.cuda.synchronize()
    kp_p, maps_p = plain_bottleneck(x, ho, wo, 0.7, sigma, align, variant)
    assert (kp - kp_p).abs().max().item() <= TOL
    assert (maps - maps_p).abs().max().item() <= fused_map_tolerance(sigma)
    kp1 = ssc.spatial_softmax_cuda(x, 0.7, variant, align)
    maps2 = gc.gaussian_fwd_cuda(kp1.reshape(-1, 2), ho, wo, sigma, align)
    assert torch.equal(kp, kp1)
    assert torch.equal(maps, maps2.reshape(maps.shape))

    rs = np.random.RandomState(24)
    g_kp = torch.from_numpy(rs.randn(*shape[:2], 2).astype(np.float32))
    g_maps = torch.from_numpy(rs.randn(*shape[:2], ho, wo).astype(np.float32))
    g_kp, g_maps = g_kp.to(cuda), g_maps.to(cuda)
    xk = x.clone().requires_grad_(True)
    torch.autograd.backward(fbc.softargmax_raster_autograd(
        xk, ho, wo, 0.7, sigma, align, variant), (g_kp, g_maps))
    xr = x.clone().requires_grad_(True)
    torch.autograd.backward(plain_bottleneck(xr, ho, wo, 0.7, sigma, align,
                                             variant), (g_kp, g_maps))
    tol = fused_grad_tolerance(x, ho, wo, 0.7, sigma, align, variant, g_kp,
                               g_maps)
    assert bool(((xk.grad - xr.grad).abs() <= tol).all())


@pytest.mark.parametrize("variant", ["marginal", "joint"])
@pytest.mark.parametrize("case", [BOTTLENECK[0], BOTTLENECK[2], BOTTLENECK[7],
                                  WIDE_BOTTLENECK[2], WIDE_BOTTLENECK[4]],
                         ids=["atari-b64", "celeba-b128", "7x13-maps",
                              "128x128", "wide-7x13-maps"])
def test_fused_bottleneck_maps_at_an_unaligned_base(cuda, case, variant):
    """K3 with its maps 4 bytes past a 16-byte boundary (no float4 runs,
    pixel by pixel): keypoints and maps equal to the aligned call's bit for
    bit, warp and block path."""
    shape, (ho, wo), sigma = case
    x = _heatmaps(*shape, cuda, seed=25)
    kp, maps = fbc.softargmax_raster_cuda(x, ho, wo, 0.7, sigma, True,
                                          variant)
    buf = torch.full((maps.numel() + 1,), float("nan"), device=cuda)
    off = buf[1:].view(maps.shape)
    assert off.data_ptr() % 16 == 4
    kp_off = torch.empty_like(kp)
    before = fbc.launches
    fbc._launch(x, kp_off, off, 0.7, sigma, True, variant)
    torch.cuda.synchronize()
    assert fbc.launches == before + 1
    assert torch.equal(kp_off, kp) and torch.equal(off, maps)


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_autoencoder_with_128_heatmaps_trains_through_the_kernels(cuda,
                                                                  variant):
    """celeba128 at stride 1 (128² heatmaps), narrow, bf16 compute: a
    forward and backward at b2 through the wide kernels (K3 in both
    variants), and K1b; every parameter gets a finite gradient."""
    cfg = get_config("celeba128").override(**{
        "model.encoder_filters": (8, 8), "model.encoder_strides": (1, 1),
        "model.decoder_filters": (8, 8),
        "model.decoder_upsample": (False, False), "model.groups": 4,
        "model.softmax_variant": variant})
    model = build_model(cfg, cuda)
    x = torch.rand((2, 3, 128, 128), device=cuda)
    before = (fbc.launches, ssc.launches, ssc.bwd_launches)
    recon, _ = model(x, x)
    ((recon - x) ** 2).mean().backward()
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip((fbc.launches, ssc.launches,
                                       ssc.bwd_launches), before))
    assert got == (1, 0, 1)
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_extract_and_render_routes_joint_to_the_fused_kernel(cuda, variant):
    """On CUDA both variants take K3 alone (K1 and K2 untouched): on the
    H100 K3 beats K1 then K2 in both (PERF.md), where the JAX
    package sends only the joint variant to its fused kernel."""
    x = _heatmaps(8, 4, 16, 16, cuda, seed=13)
    before = (fbc.launches, ssc.launches, gc.launches)
    kp, maps = extract_and_render(x, 16, 16, 1.0, 0.1, variant, True)
    torch.cuda.synchronize()
    after = (fbc.launches, ssc.launches, gc.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 0, 0)
    kp_p, maps_p = plain_bottleneck(x, 16, 16, 1.0, 0.1, True, variant)
    assert (kp - kp_p).abs().max().item() <= TOL
    assert (maps - maps_p).abs().max().item() <= fused_map_tolerance(0.1)


def test_fused_bottleneck_rejects_what_it_does_not_take(cuda):
    x = _heatmaps(2, 3, 16, 16, cuda)
    before = fbc.launches
    with pytest.raises(ValueError, match="float32"):
        fbc.softargmax_raster_cuda(x.to(torch.bfloat16), 16, 16)
    with pytest.raises(ValueError, match="contiguous"):
        fbc.softargmax_raster_cuda(x.transpose(2, 3), 16, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fbc.softargmax_raster_cuda(x.cpu(), 16, 16)
    wide = _heatmaps(1, 1, 65, 8, cuda)      # computes: the block kernel
    kp, maps = fbc.softargmax_raster_cuda(wide, 16, 16)
    torch.cuda.synchronize()
    kp_p, maps_p = plain_bottleneck(wide, 16, 16)
    assert (kp - kp_p).abs().max().item() <= TOL
    assert (maps - maps_p).abs().max().item() <= fused_map_tolerance(0.1)
    with pytest.raises(ValueError, match="H \\+ W <= 4096"):
        fbc.softargmax_raster_cuda(_heatmaps(1, 1, 65, 4032, cuda), 16, 16,
                                   variant="marginal")
    with pytest.raises(ValueError, match="variant"):
        fbc.softargmax_raster_cuda(x, 16, 16, variant="mean")
    with pytest.raises(ValueError, match="sigma"):
        fbc.softargmax_raster_cuda(x, 16, 16, sigma=0.0)
    with pytest.raises(ValueError, match="output size"):
        fbc.softargmax_raster_cuda(x, 0, 16)
    # Ho + Wo = gaussian_cuda.MAX_TABLE (227 KB, the raster backward's own
    # limit) computes on the warp path; one more float raises
    edge = _heatmaps(1, 2, 16, 16, cuda, seed=27)
    wo = gc.MAX_TABLE - 2
    kp, maps = fbc.softargmax_raster_cuda(edge, 2, wo, 1.0, 0.1, True,
                                          "marginal")
    torch.cuda.synchronize()
    kp_p, maps_p = plain_bottleneck(edge, 2, wo, 1.0, 0.1, True, "marginal")
    assert (kp - kp_p).abs().max().item() <= TOL
    assert (maps - maps_p).abs().max().item() <= fused_map_tolerance(0.1)
    with pytest.raises(ValueError, match="output size"):
        fbc.softargmax_raster_cuda(edge, 2, wo + 1)
    assert fbc.launches == before + 2


# maps past Ho + Wo = 4,096 (the kernel's limit before its table could take
# a block's 227 KB): just above it, and tables above the default 48 KB of
# shared memory (the kernel opts in) on the warp and the block path
BIG_OUT = [((2, 3, 32, 32), (8, 4100)), ((1, 2, 16, 16), (4, 13000)),
           ((1, 2, 65, 8), (3, 12400))]


@pytest.mark.parametrize("variant", ["marginal", "joint"])
@pytest.mark.parametrize("case", BIG_OUT,
                         ids=["4108", "13004-warp", "12403-block"])
def test_fused_bottleneck_takes_the_raster_s_output_sizes(cuda, case,
                                                          variant):
    """``extract_and_render`` (K3 in both variants) at output sizes the
    raster kernel takes: keypoints and maps equal K1 then K2 bit for bit
    and lie within the tolerances of plain, and the composed backward is
    within ``testing.fused_grad_tolerance`` of the plain autograd."""
    shape, (ho, wo) = case
    x = _heatmaps(*shape, cuda, seed=25)
    before = fbc.launches
    xk = x.clone().requires_grad_(True)
    kp, maps = extract_and_render(xk, ho, wo, 0.7, 0.1, variant, True)
    torch.cuda.synchronize()
    assert fbc.launches == before + 1
    kp1 = ssc.spatial_softmax_cuda(x, 0.7, variant, True)
    maps2 = gc.gaussian_fwd_cuda(kp1.reshape(-1, 2), ho, wo, 0.1, True)
    assert torch.equal(kp, kp1)
    assert torch.equal(maps, maps2.reshape(maps.shape))
    xr = x.clone().requires_grad_(True)
    kp_p, maps_p = plain_bottleneck(xr, ho, wo, 0.7, 0.1, True, variant)
    assert (kp - kp_p).abs().max().item() <= TOL
    assert (maps - maps_p).abs().max().item() <= fused_map_tolerance(0.1)
    rs = np.random.RandomState(26)
    g_kp = torch.from_numpy(rs.randn(*shape[:2], 2).astype(np.float32))
    g_maps = torch.from_numpy(rs.randn(*shape[:2], ho, wo).astype(np.float32))
    g_kp, g_maps = g_kp.to(cuda), g_maps.to(cuda)
    torch.autograd.backward((kp, maps), (g_kp, g_maps))
    torch.autograd.backward((kp_p, maps_p), (g_kp, g_maps))
    tol = fused_grad_tolerance(x, ho, wo, 0.7, 0.1, True, variant, g_kp,
                               g_maps)
    assert bool(((xk.grad - xr.grad).abs() <= tol).all())


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_transporter_step_launches_and_reaches_every_parameter(cuda,
                                                              variant):
    """Full-width transporter_atari in bf16 compute, one forward and
    backward at b2: the source branch has no graph, so per pass K3 runs
    twice (both variants), and K1b and the K2 backward once; every
    (float32) parameter gets a finite gradient."""
    cfg = get_config("transporter_atari").override(
        **{"model.softmax_variant": variant})
    model = build_model(cfg, cuda)
    x, y = (torch.rand((2, 1, 64, 64), device=cuda) for _ in range(2))
    names = ("fbc", "ssc fwd", "ssc bwd", "gc fwd", "gc bwd")

    def counts():
        return dict(zip(names, (fbc.launches, ssc.launches,
                                ssc.bwd_launches, gc.launches,
                                gc.bwd_launches)))
    before = counts()
    recon, kp = model(x, y)
    ((recon - y) ** 2).mean().backward()
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in counts().items()}
    assert got == {"fbc": 2, "ssc fwd": 0, "ssc bwd": 1, "gc fwd": 0,
                   "gc bwd": 1}
    assert recon.shape == (2, 1, 64, 64) and kp.shape == (2, 4, 2)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert model.keynet.trunk.Conv_0.weight.grad.abs().sum().item() > 0


# --- banded warps (K7, K8) --------------------------------------------------

BANDED = {"tree": (banded.warp_bilinear_tree, plain_banded.warp_bilinear_tree,
                   "tree_launches"),
          "rowwin": (banded.warp_bilinear_rowwin,
                     plain_banded.warp_bilinear_rowwin, "rowwin_launches")}


def _banded_grid(cuda, violated: bool) -> torch.Tensor:
    """celeba128's b128 shape: a smooth warp of the 128² image (the window
    of y_window 40 holds), or y alternating between -0.9 and 0.9 from row to
    row and column to column (every band is violated)."""
    if violated:
        xs = torch.linspace(-0.9, 0.9, 128).expand(128, 128)
        ij = torch.arange(128)[:, None] + torch.arange(128)[None]
        gy = torch.where(ij % 2 == 0, -0.9, 0.9)
        grid = torch.stack([xs, gy], -1)
        return grid.expand(128, 128, 128, 2).contiguous().to(cuda)
    rs = np.random.RandomState(5)
    field = upsample_field_aligned(
        torch.from_numpy((0.05 * rs.randn(128, 5, 5, 2)).astype(np.float32)),
        128, 128)
    ident = torch.stack(torch.meshgrid(torch.linspace(-1, 1, 128),
                                       torch.linspace(-1, 1, 128),
                                       indexing="xy"), -1)
    return (ident * 0.95 + field).contiguous().to(cuda)


@pytest.mark.parametrize("kernel", ["tree", "rowwin"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("violated", [False, True])
def test_banded_warp_matches_plain_and_k4(cuda, kernel, padding, violated):
    """K7 and K8 at celeba128's b128 3x128² bf16, y_window 40: within one
    bf16 ulp of the plain version; where the window holds, equal to K4 bit
    for bit; where it is violated, zeros past the band."""
    entry, plain, counter = BANDED[kernel]
    img = torch.from_numpy(np.random.RandomState(6).rand(128, 3, 128, 128)
                           .astype(np.float32) * 0.8 + 0.1).to(cuda)
    img = img.to(torch.bfloat16)
    grid = _banded_grid(cuda, violated)
    before = getattr(ecu, counter)
    got = entry(img, grid, padding, True, 40)
    torch.cuda.synchronize()
    assert getattr(ecu, counter) == before + 1
    want = plain(img, grid, padding, True, 40)
    assert got.dtype == torch.bfloat16 and got.shape == (128, 3, 128, 128)
    assert bool(((got.float() - want.float()).abs()
                 <= bf16_ulp(want)).all())
    k4 = warp_cuda.warp_bilinear_cuda(img, grid, padding, True)
    if violated:
        assert bool((got == 0).any()) and not bool((k4 == 0).any())
    else:
        assert torch.equal(got, k4)


def test_banded_warp_rejects(cuda):
    img = torch.zeros((1, 3, 64, 64), dtype=torch.bfloat16, device=cuda)
    grid = torch.zeros((1, 8, 8, 2), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        ecu.warp_bilinear_tree_cuda(img.float(), grid)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ecu.warp_bilinear_rowwin_cuda(img.cpu(), grid.cpu())
    with pytest.raises(ValueError, match="multiple of 8"):
        ecu.warp_bilinear_tree_cuda(img, grid[:, :7].contiguous())
    with pytest.raises(ValueError, match="Wo <= 3584"):
        ecu.warp_bilinear_tree_cuda(img, torch.zeros((1, 8, 3585, 2),
                                                     device=cuda))


def _smooth_grid(b, ho, wo, span, seed, angle=0.1):
    """A grid whose output rows step evenly through source y in [-span,
    span], rotated by ``angle`` and jittered: the windows of the cases below
    hold, with bands narrower than the image."""
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.linspace(-span, span, ho),
                         np.linspace(-0.9, 0.9, wo), indexing="ij")
    c, s_ = np.cos(angle), np.sin(angle)
    g = np.stack([c * xs - s_ * ys, s_ * xs + c * ys], -1)
    g = g + 0.005 * rs.randn(b, ho, wo, 2)
    return torch.from_numpy(np.clip(g, -0.98, 0.98).astype(np.float32))


# (image shape, output Ho x Wo, y span, y_window, what the case exercises)
BANDED_EDGES = [((1, 3, 128, 64), (8, 21), 0.2, 40, "odd Wo, Ho = 8, B = 1"),
                ((2, 3, 96, 80), (16, 20), 0.3, 24, "Wo < 32"),
                ((2, 3, 128, 1024), (64, 256), 0.9, 40, "1,024-wide image"),
                ((1, 2, 64, 64), (8, 600), 0.1, 16, "Wo = 600, 38 KB band"),
                ((3, 3, 128, 128), (128, 128), 0.9, 40,
                 "8-byte aligned grid")]


@pytest.mark.parametrize("kernel", ["tree", "rowwin"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("case", BANDED_EDGES,
                         ids=["odd-wo", "narrow-wo", "wide-image",
                              "wide-band", "unaligned-grid"])
def test_banded_warp_edge_geometry(cuda, case, padding, kernel):
    """K7 and K8 where the launch geometry changes: one pixel a thread (odd
    Wo; a grid 8 but not 16 bytes aligned), few pixels a band, a wide image,
    a wide band (K7's grid of 38 KB in shared memory, 19 items a thread).
    Within one bf16 ulp of the plain version, and equal to K4 bit for bit
    (every case's window holds)."""
    shape, (ho, wo), span, y_window, what = case
    entry, plain, counter = BANDED[kernel]
    img = torch.from_numpy(np.random.RandomState(7).rand(*shape)
                           .astype(np.float32)).to(cuda).to(torch.bfloat16)
    grid = _smooth_grid(shape[0], ho, wo, span, 8).to(cuda)
    if what == "8-byte aligned grid":
        buf = torch.empty(grid.numel() + 2, device=cuda)
        grid = buf[2:].view(grid.shape).copy_(grid)
        assert grid.data_ptr() % 16 == 8
    before = getattr(ecu, counter)
    got = entry(img, grid, padding, True, y_window)
    torch.cuda.synchronize()
    assert getattr(ecu, counter) == before + 1
    want = plain(img, grid, padding, True, y_window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(((got.float() - want.float()).abs() <= bf16_ulp(want)).all())
    assert torch.equal(want, plain(img, grid, padding, True, None)
                       if kernel == "tree" else
                       plain(img, grid, padding, True, shape[2]))
    assert torch.equal(got, warp_cuda.warp_bilinear_cuda(img, grid, padding,
                                                         True))


# --- the train loop's data on the card ------------------------------------------

def test_resident_sampler_stays_on_the_card(cuda, tmp_path):
    """A resident store's batches are drawn, gathered and converted on the
    card; the same generator seed gives the same rows."""
    from keypoints_tpu_torch.data.device import DeviceDataset
    from keypoints_tpu_torch.data.records import FrameStore, episode_pairs
    frames = np.arange(40, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 1, 4, 4), np.uint8)
    path = str(tmp_path / "s.npy")
    FrameStore.write(path, frames, episode_pairs([40], 2))
    ds = DeviceDataset(FrameStore(path), device=cuda)
    assert ds.frames.is_cuda and ds.pairs.is_cuda
    gen = torch.Generator(device=cuda).manual_seed(3)
    a, b = ds.sample_pair(gen, 64)
    assert a.is_cuda and b.is_cuda and a.dtype == torch.float32
    ia = (a[:, 0, 0, 0] * 255).round().long()
    assert torch.equal((b[:, 0, 0, 0] * 255).round().long(), ia + 2)
    again = ds.sample_pair(torch.Generator(device=cuda).manual_seed(3), 64)
    assert torch.equal(again[0], a)


def test_collect_scripted_pong_on_cuda_matches_cpu(cuda):
    """The episodes rendered on the card (the ball through the raster
    kernel) equal the CPU's frames within one uint8 level."""
    from keypoints_tpu_torch.data.collect import collect_scripted_pong
    before = gc.launches
    got, lengths = collect_scripted_pong(3, 20, 64, seed=1, device=cuda)
    assert gc.launches == before + 3                 # one raster an episode
    want, want_lengths = collect_scripted_pong(3, 20, 64, seed=1,
                                               device="cpu")
    assert lengths == want_lengths
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_k1_op_on_cuda_is_the_kernel_and_passes_opcheck(cuda, variant, align):
    """The custom op on a CUDA tensor launches K1 once a call (its result
    the direct wrapper's bits), raises where the kernel raises, and passes
    ``torch.library.opcheck``."""
    x = _heatmaps(4, 10, 32, 32, cuda, seed=5)
    before = ssc.launches
    got = ssc.spatial_softmax_op(x, 0.7, variant, align)
    torch.cuda.synchronize()
    assert ssc.launches == before + 1
    assert torch.equal(got, ssc.spatial_softmax_cuda(x, 0.7, variant, align))
    torch.library.opcheck(ssc.spatial_softmax_op, (x, 0.7, variant, align))
    with pytest.raises(ValueError, match="float32"):
        ssc.spatial_softmax_op(x.to(torch.bfloat16), 0.7, variant, align)


@pytest.mark.parametrize("input_dtype", ["float32", "uint8"])
def test_cuda_artifact_equals_the_live_extract(cuda, input_dtype,
                                              monkeypatch):
    """A bundle exported on the card holds K1 as one op node a bucket;
    each bucket answers as the live extract at the same bucket, bit for
    bit, its first call eagerly then from its CUDA graph; the wrapper sees
    the first call's launch and the capture's (2), a replay none (it calls
    no wrapper), so the profiler counts the replay's one K1 launch, and the
    replay's answer equals the eager module's on the same images; it
    refuses to load for the CPU."""
    import re
    from torch.profiler import ProfilerActivity, profile
    from keypoints_tpu_torch import export
    from keypoints_tpu_torch.serve import make_live_extract
    made = []

    class Recorded(export.GraphedBucket):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setattr(export, "GraphedBucket", Recorded)
    cfg = get_config("celeba128").override(**{
        "model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
        "model.groups": 4, "data.image_size": 32})
    data = export.export_extract_bundle(cfg, None, [1, 4], cuda, input_dtype)
    ext = export.load_extract(data)
    live = make_live_extract(cfg, None, [1, 4], cuda, input_dtype)
    rs = np.random.RandomState(6)
    for n, counted in ((1, 2), (3, 2), (4, 0)):
        x = (rs.rand(n, 3, 32, 32) * 255).astype(np.uint8)
        before = ssc.launches
        got = ext(x)
        assert ssc.launches == before + counted
        assert np.array_equal(got, live(x))
    assert len(made) == 2 and all(g.graph is not None for g in made)
    x = (rs.rand(4, 3, 32, 32) * 255).astype(np.uint8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # spins at both edges: a kernel at a trace's very edge can be missed
        torch.cuda._sleep(20_000_000)
        got = ext(x)
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
    k1 = [e for e in prof.events() if re.search(
        r"::(marginal_fwd|joint_fwd|block_fwd)\s*[<(]", e.name)]
    assert len(k1) == 1, [e.name for e in k1]
    with torch.no_grad():
        want = export._extractor(cfg, None, cuda, input_dtype)(
            torch.from_numpy(ext.coerce(x)).to(cuda)).cpu().numpy()
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="runs there only"):
        export.load_extract(data, "cpu")
