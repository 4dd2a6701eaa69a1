"""The CUDA kernels against their plain PyTorch versions, on the GPU.

The soft-argmax forward and backward, the Gaussian raster forward and
backward, the bilinear warps (dense grid and coarse field) and the 2×2 max
pool forward and backward; their dispatchers and autograd Functions;
launch counts; rejections; and a backward through the full model and
through the VGG perceptual loss.

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
from keypoints_tpu_torch.kernels import gaussian_cuda as gc
from keypoints_tpu_torch.kernels import pool_cuda as pc
from keypoints_tpu_torch.kernels import spatial_softmax_cuda as ssc
from keypoints_tpu_torch.kernels import (gaussian_maps, max_pool_2x2,
                                         spatial_softmax, warp_cuda,
                                         warp_sample, warp_sample_field)
from keypoints_tpu_torch.ops.gaussian import gaussian_maps as plain_gaussian
from keypoints_tpu_torch.ops.pool import max_pool_2x2 as plain_pool
from keypoints_tpu_torch.ops.spatial_softmax import spatial_softmax as plain
from keypoints_tpu_torch.ops.warp import grid_sample as plain_warp
from keypoints_tpu_torch.ops.warp import upsample_field_aligned
from keypoints_tpu_torch.testing import bf16_ulp, random_images
from keypoints_tpu_torch.train import make_loss
from keypoints_tpu_torch.training import build_model

pytestmark = pytest.mark.cuda

TOL = 2e-5   # f32 on both sides; only the order of the sums differs
SHAPES = [(10, 32, 32), (2560, 32, 32), (10240, 32, 32), (40, 16, 16),
          (7, 13, 29)]


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
                                   (3, 7, 33, 31)],
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
    with pytest.raises(ValueError, match="1..64"):
        ssc.spatial_softmax_cuda(_heatmaps(1, 1, 65, 8, cuda))
    with pytest.raises(ValueError, match="variant"):
        ssc.spatial_softmax_cuda(x, variant="mean")


# --- soft-argmax backward (K1b) ----------------------------------------------

def _plain_grad(x, g, temperature, variant, align):
    x = x.clone().requires_grad_(True)
    (plain(x, temperature, variant, align) * g).sum().backward()
    return x.grad


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["marginal", "joint"])
@pytest.mark.parametrize("shape", [(128, 10, 32, 32), (1, 7, 13, 29),
                                   (2, 3, 64, 64), (3, 2, 1, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_softmax_backward_matches_plain_autograd(cuda, shape, variant, align):
    x = _heatmaps(*shape, cuda, seed=3)
    g = torch.from_numpy(np.random.RandomState(4).randn(
        *shape[:2], 2).astype(np.float32)).to(cuda)
    kp = ssc.spatial_softmax_cuda(x, 0.7, variant, align)
    before = ssc.bwd_launches
    got = ssc.spatial_softmax_bwd_cuda(x, kp, g, 0.7, variant, align)
    torch.cuda.synchronize()
    assert ssc.bwd_launches == before + 1
    want = _plain_grad(x, g, 0.7, variant, align)
    assert got.shape == x.shape
    assert (got - want).abs().max().item() <= 1e-5


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

@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape", [(128, 10, 32, 32), (2, 3, 13, 29)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gaussian_forward_and_backward_match_plain(cuda, shape, align):
    b, k, h, w = shape
    rs = np.random.RandomState(6)
    kp = torch.from_numpy((rs.rand(b, k, 2) * 2.2 - 1.1).astype(
        np.float32)).to(cuda)
    g = torch.from_numpy(rs.randn(b, k, h, w).astype(np.float32)).to(cuda)
    fwd, bwd = gc.launches, gc.bwd_launches
    x = kp.clone().requires_grad_(True)
    maps = gaussian_maps(x, h, w, 0.1, align)
    assert maps.grad_fn is not None
    (maps * g).sum().backward()
    torch.cuda.synchronize()
    assert (gc.launches, gc.bwd_launches) == (fwd + 1, bwd + 1)
    ref = kp.clone().requires_grad_(True)
    want = plain_gaussian(ref, h, w, 0.1, align)
    (want * g).sum().backward()
    assert (maps - want).abs().max().item() <= 1e-5
    # the sums over H*W run in another order: 1e-4 of the gradient's scale
    scale = ref.grad.abs().max().item()
    assert (x.grad - ref.grad).abs().max().item() <= 1e-4 * scale


# --- bilinear warp (K4) ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("case", [((128, 3, 128, 128), (128, 128)),
                                  ((2, 3, 13, 29), (11, 17))],
                         ids=["b128-128", "ragged"])
def test_warp_matches_plain_and_grid_sample(cuda, case, padding, align,
                                            dtype):
    shape, out_hw = case
    rs = np.random.RandomState(7)
    img = torch.from_numpy(rs.rand(*shape).astype(np.float32)).to(cuda)
    img = img.to(dtype)
    # points outside the image included: the grid spans [-1.2, 1.2]
    grid = torch.from_numpy((rs.rand(shape[0], *out_hw, 2) * 2.4 - 1.2)
                            .astype(np.float32)).to(cuda)
    before = warp_cuda.launches
    got = warp_sample(img, grid, padding, align)
    torch.cuda.synchronize()
    assert warp_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], 3, *out_hw)
    want = plain_warp(img, grid, padding, align)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
        lib = F.grid_sample(img, grid, "bilinear", padding, align)
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
    every (float32) parameter through the kernels and is finite."""
    cfg = get_config("celeba128")
    model = build_model(cfg, cuda)
    x = torch.rand((2, 3, 128, 128), device=cuda)
    y = torch.rand((2, 3, 128, 128), device=cuda)
    counts = (ssc.launches, ssc.bwd_launches, gc.launches, gc.bwd_launches)
    recon, kp = model(x, y)
    ((recon - y) ** 2).mean().backward()
    torch.cuda.synchronize()
    assert (ssc.launches, ssc.bwd_launches, gc.launches, gc.bwd_launches) \
        == tuple(c + 1 for c in counts)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert model.keynet.trunk.Conv_0.weight.grad.abs().sum().item() > 0


# --- field warp (K5) ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("case", [((16, 3, 256, 256), 33, (256, 256)),
                                  ((2, 3, 45, 61), 9, (37, 53)),
                                  ((3, 3, 20, 30), 33, (19, 23))],
                         ids=["b16-256", "ragged-F9", "ragged-F33"])
def test_field_warp_matches_upsample_and_plain_warp(cuda, case, padding,
                                                     align, dtype):
    """The field kernel against ``upsample_field_aligned`` + the plain warp:
    f32 within 1e-4 (JAX's bar for its field kernel; the upsample is
    rebuilt to the bit, so only the corner sum's order differs), bf16
    within one bf16 ulp."""
    shape, f, out_hw = case
    rs = np.random.RandomState(8)
    img = torch.from_numpy(rs.rand(*shape).astype(np.float32)).to(cuda)
    img = img.to(dtype)
    field = torch.from_numpy((rs.rand(shape[0], f, f, 2) * 2.4 - 1.2)
                             .astype(np.float32)).to(cuda)
    before = warp_cuda.field_launches
    got = warp_cuda.warp_field_cuda(img, field, *out_hw, padding, align)
    torch.cuda.synchronize()
    assert warp_cuda.field_launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], 3, *out_hw)
    want = plain_warp(img, upsample_field_aligned(field, *out_hw), padding,
                      align)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4
    else:
        assert bool((err <= bf16_ulp(want)).all())


@pytest.mark.parametrize("width,kernel", [(256, "field"), (128, "dense")])
def test_warp_sample_field_routes_by_output_width(cuda, width, kernel):
    img = torch.rand((2, 3, width, width), device=cuda)
    field = torch.rand((2, 33, 33, 2), device=cuda) * 2 - 1
    before = (warp_cuda.field_launches, warp_cuda.launches)
    got = warp_sample_field(img, field, width, width, "border", True)
    torch.cuda.synchronize()
    after = (warp_cuda.field_launches, warp_cuda.launches)
    assert after == ((before[0] + 1, before[1]) if kernel == "field"
                     else (before[0], before[1] + 1))
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
