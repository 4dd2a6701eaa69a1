"""The CUDA soft-argmax kernel against its plain PyTorch version, on the GPU.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (a CUDA kernel has no CPU mode). The kernel is built with nvcc at
first use. On a GPU machine without JAX, run it without the suite's
conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from keypoints_tpu_torch.kernels import spatial_softmax
from keypoints_tpu_torch.kernels import spatial_softmax_cuda as ssc
from keypoints_tpu_torch.ops.spatial_softmax import spatial_softmax as plain

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
