"""The GroupNorm + ReLU of the conv blocks: the dispatcher, the custom op,
the models, and the CUDA kernels against their plain version.

On the CPU (no JAX here): ``kernels.group_norm_relu`` equals the blocks'
former ``F.relu(GroupNorm(x))`` bit for bit, forward and backward, in bf16
and f32 at C/G of 1, 4 and 32; ``torch.library.opcheck`` of the forward op;
the plain statistics; an extractor exported on the CPU answers as the live
model does and holds the plain ops, one traced on fake CUDA tensors holds
one op node a block and no aten GroupNorm. The tests marked ``cuda`` hold
the kernels to the plain version on the card and skip here (a CUDA kernel
has no CPU mode); run them there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_group_norm.py -q
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from keypoints_tpu_torch import export
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.kernels import group_norm_cuda as gnc
from keypoints_tpu_torch.kernels import group_norm_relu
from keypoints_tpu_torch.models.nets import Decoder, Encoder, GroupNorm
from keypoints_tpu_torch.ops.group_norm import (group_norm_relu_stats,
                                                group_norm_relu as plain)
from keypoints_tpu_torch.testing import bf16_ulp, group_norm_relu_edge

OP = "keypoints_tpu_torch.group_norm_relu_fwd.default"
# celeba128's structure at 32² with narrow filters, f32: 2 blocks in Psi
NARROW = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
          "model.decoder_filters": (16, 8),
          "model.decoder_upsample": (True, True), "model.groups": 4,
          "model.num_keypoints": 4, "data.image_size": 32}
DTYPES = [torch.float32, torch.bfloat16]


def _norm(channels: int, groups: int, seed: int = 0) -> GroupNorm:
    norm = GroupNorm(groups, channels, eps=1e-5)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.5 * torch.randn(channels, generator=gen))
        norm.bias.copy_(0.5 * torch.randn(channels, generator=gen))
    return norm


def _x(shape, dtype, seed: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    offsets = torch.randn(1, shape[1], 1, 1, generator=gen)
    return (1.5 * torch.randn(shape, generator=gen) + offsets).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("channels,groups", [(8, 8), (32, 8), (32, 1)],
                         ids=["cg1", "cg4", "cg32"])
def test_cpu_dispatch_is_the_former_composition_bit_for_bit(channels, groups,
                                                            dtype):
    norm = _norm(channels, groups)
    x = _x((3, channels, 6, 5), dtype).requires_grad_(True)
    x_ref = x.detach().clone().requires_grad_(True)
    g = _x((3, channels, 6, 5), dtype, seed=2)
    got = group_norm_relu(x, norm)
    grads = torch.autograd.grad(got, (x, norm.weight, norm.bias), g)
    want = F.relu(norm(x_ref))
    want_grads = torch.autograd.grad(want, (x_ref, norm.weight, norm.bias), g)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    for a, b in zip(grads, want_grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,groups", [((2, 8, 4, 4), 8),
                                          ((3, 32, 5, 7), 8),
                                          ((1, 16, 3, 3), 1)])
def test_forward_op_passes_opcheck(shape, groups, dtype):
    norm = _norm(shape[1], groups)
    torch.library.opcheck(
        gnc.group_norm_relu_op,
        (_x(shape, dtype), norm.weight.detach(), norm.bias.detach(), groups,
         1e-5))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_statistics_are_the_groups_moments(dtype):
    norm = _norm(24, 6)
    x = _x((4, 24, 5, 3), dtype)
    y, mean, rstd = group_norm_relu_stats(x, 6, norm.weight, norm.bias, 1e-5)
    groups = x.float().reshape(4, 6, -1)
    assert torch.equal(y, plain(x, 6, norm.weight, norm.bias, 1e-5))
    assert mean.shape == rstd.shape == (4, 6)
    assert mean.dtype == rstd.dtype == torch.float32
    torch.testing.assert_close(mean, groups.mean(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        rstd, (groups.var(-1, unbiased=False) + 1e-5).rsqrt(), rtol=1e-5,
        atol=0)


@pytest.mark.parametrize("net", ["encoder", "decoder"])
def test_blocks_compute_their_former_composition(net):
    """Encoder and Decoder on the CPU: the blocks' output as when each ran
    F.relu(norm(conv(x)))."""
    torch.manual_seed(0)
    model = (Encoder(3, (8, 16), (1, 2), groups=4, dtype=torch.bfloat16)
             if net == "encoder" else
             Decoder(16, 3, (16, 8), (True, False), groups=4,
                     dtype=torch.bfloat16))
    x = _x((2, 3 if net == "encoder" else 16, 8, 8), torch.float32)
    want = x.to(torch.bfloat16)
    for conv, norm in model.blocks:
        want = F.relu(norm(conv(want)))
    if net == "decoder":
        want = model.head(want)
    assert torch.equal(model(x), want)


def test_dispatch_rejects_other_devices():
    norm = _norm(8, 4)
    with pytest.raises(ValueError, match="no GroupNorm"):
        group_norm_relu(torch.empty((1, 8, 2, 2), device="meta"), norm)


def test_kernel_wrappers_take_cuda_tensors_only():
    norm = _norm(8, 4)
    x = _x((1, 8, 2, 2), torch.float32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        gnc.group_norm_relu_fwd_cuda(x, norm.weight, norm.bias, 4, 1e-5)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        gnc.group_norm_relu_bwd_cuda(x, x, x[:, :4, 0, 0], x[:, :4, 0, 0],
                                     norm.weight, norm.bias, 4)


def test_module_imports_without_cuda():
    code = ("import torch; from keypoints_tpu_torch.kernels import "
            "group_norm_cuda as g; from keypoints_tpu_torch.models import "
            "nets; assert not torch.cuda.is_available(); "
            "print(hasattr(torch.ops.keypoints_tpu_torch, "
            "'group_norm_relu_fwd'), g.launches, g.bwd_launches)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "0", "0"]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_cpu_export_answers_as_the_live_model(dtype):
    """An extractor exported on the CPU holds the plain ops (no GroupNorm op
    node) and answers as the live extractor, bit for bit."""
    cfg = get_config("celeba128").override(**NARROW)
    extractor = export._extractor(cfg, None, "cpu", dtype)
    data = export._export(extractor, cfg, 2, dtype)
    program = torch.export.load(io.BytesIO(data))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert OP not in targets
    assert any("group_norm" in t for t in targets)
    rs = np.random.RandomState(0)
    images = rs.rand(2, 3, 32, 32).astype(np.float32)
    if dtype == "uint8":
        images = (images * 255).astype(np.uint8)
    with torch.no_grad():
        want = extractor(torch.from_numpy(images))
    got = export.load_extract(data)(images)
    np.testing.assert_array_equal(got, want.numpy())


def test_cuda_trace_holds_one_op_node_a_block():
    """The extractor traced on (fake) CUDA tensors, as the card's export
    traces it: each of Psi's blocks is one node of the GroupNorm + ReLU op,
    and no aten GroupNorm or ReLU is left."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config("celeba128").override(**NARROW)
    extractor = export._extractor(cfg, None, "cpu", "float32")
    with FakeTensorMode(allow_non_fake_inputs=True):
        for module in extractor.modules():
            for name, p in list(module.named_parameters(recurse=False)):
                setattr(module, name, torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="cuda"),
                    requires_grad=False))
        x = torch.zeros((2, 3, 32, 32), device="cuda")
        with torch.no_grad():
            program = torch.export.export(extractor, (x,))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(OP) == len(cfg.model.encoder_filters)
    assert not [t for t in targets
                if t != OP and ("group_norm" in t or "relu" in t)]


# ---- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    return torch.device("cuda")


def _tol(want: torch.Tensor, rtol: float, bf16: bool) -> float:
    top = want.float().abs().max()
    return float(rtol * top + (bf16_ulp(top) if bf16 else 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,groups", [
    ((4, 32, 32, 32), 8), ((2, 256, 16, 16), 8), ((3, 24, 13, 29), 8),
    ((5, 8, 9, 9), 8), ((2, 64, 8, 8), 1), ((2, 32, 192, 192), 8)],
    ids=["held", "cg32", "ragged", "cg1", "one_group", "read_twice"])
def test_kernels_match_plain(cuda, shape, groups, dtype):
    """Forward (y, mean, rstd) and backward (dx, dgamma, dbeta) against the
    plain version and its autograd; the tolerances are chip_smoke.py's
    phase 39's: f32 sums in another order, one bf16 spacing."""
    norm = _norm(shape[1], groups).to(cuda)
    x, g = _x(shape, dtype).to(cuda), _x(shape, dtype, seed=3).to(cuda)
    w, b = norm.weight.detach(), norm.bias.detach()
    got = gnc.group_norm_relu_fwd_cuda(x, w, b, groups, 1e-5)
    got += gnc.group_norm_relu_bwd_cuda(g, x, got[1], got[2], w, b, groups)
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = plain(xr, groups, wr, br, 1e-5)
    want = (y.detach(), *group_norm_relu_stats(x, groups, w, b, 1e-5)[1:],
            *torch.autograd.grad(y, (xr, wr, br), g))
    # dx off the ReLU's edge, where two right f32 computations can take
    # different masks, and the most the edge's flips move each gradient
    edge, room = group_norm_relu_edge(x, w, b, g, groups, 1e-5)
    bf16 = dtype == torch.bfloat16
    for name, k, p, rtol, rounded in zip(
            ("y", "mean", "rstd", "dx", "dgamma", "dbeta"), got, want,
            (2e-5, 2e-5, 2e-5, 2e-5, 1e-4, 1e-4),
            (bf16, False, False, bf16, False, False)):
        assert k.dtype == p.dtype and k.shape == p.shape
        d = (k.float() - p.float()).abs()
        if name == "dx":
            d = d.masked_fill(edge, 0)
        if name in room:
            d = (d - room[name]).clamp_min(0)
        assert d.max() <= _tol(p, rtol, rounded), name


@pytest.mark.cuda
def test_kernels_are_deterministic_and_counted(cuda):
    norm = _norm(64, 8).to(cuda)
    x = _x((8, 64, 32, 32), torch.bfloat16).to(cuda).requires_grad_(True)
    g = _x((8, 64, 32, 32), torch.bfloat16, seed=4).to(cuda)
    gnc.launches = gnc.bwd_launches = 0
    runs = []
    for _ in range(2):
        y = group_norm_relu(x, norm)
        runs.append((y, *torch.autograd.grad(y, (x, norm.weight, norm.bias),
                                             g)))
    assert (gnc.launches, gnc.bwd_launches) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    norm = _norm(8, 4).to(cuda)
    w, b = norm.weight.detach(), norm.bias.detach()
    x = torch.zeros((1, 8, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="multiple of groups"):
        gnc.group_norm_relu_fwd_cuda(x, w, b, 3, 1e-5)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gnc.group_norm_relu_fwd_cuda(x.half(), w, b, 4, 1e-5)
    with pytest.raises(ValueError, match=r"weight must be \(8,\)"):
        gnc.group_norm_relu_fwd_cuda(x, w[:4], b, 4, 1e-5)
