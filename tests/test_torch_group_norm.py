"""The GroupNorm + ReLU of the conv blocks: the dispatcher, the custom op,
the models, and the CUDA kernels against their plain version.

On the CPU (no JAX here): ``kernels.group_norm_relu`` equals the blocks'
former ``F.relu(GroupNorm(x))`` bit for bit, forward and backward, in bf16
and f32 at C/G of 1, 4 and 32, and on a channels_last input the NCHW
result bit for bit; with a conv bias, the plain op and the dispatcher equal
the add then the norm, bit for bit with its gradient; ``torch.library
.opcheck`` of the forward op in both layouts, with and without a conv bias,
and its fake kernel keeps the input's strides; the plain statistics; the
nets on the CPU as before (NCHW, the conv keeping its bias), parameter
gradients too; the channels_last weight cast's gradient; an extractor
exported on the CPU answers as the live model does and holds the plain ops,
one traced on fake CUDA tensors holds per block a conv without its bias and
one op node that takes it, and no aten GroupNorm.
The tests marked ``cuda`` hold both kernel pairs to the plain version on
the card and skip here (a CUDA kernel has no CPU mode); run them there
with

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
from keypoints_tpu_torch.models import nets
from keypoints_tpu_torch.models.nets import (Decoder, Encoder, GroupNorm,
                                             KeyNet)
from keypoints_tpu_torch.ops.group_norm import (group_norm_relu_stats,
                                                group_norm_relu as plain)
from keypoints_tpu_torch.testing import (GROUP_NORM_BLOCKS,
                                         GROUP_NORM_OTHER, bf16_ulp,
                                         group_norm_inputs,
                                         group_norm_relu_edge,
                                         share_cpu_threads)

share_cpu_threads()

OP = "keypoints_tpu_torch.group_norm_relu_fwd.default"
# celeba128's structure at 32² with narrow filters, f32: 2 blocks in Psi
NARROW = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
          "model.decoder_filters": (16, 8),
          "model.decoder_upsample": (True, True), "model.groups": 4,
          "model.num_keypoints": 4, "data.image_size": 32}
DTYPES = [torch.float32, torch.bfloat16]
LAYOUTS = [torch.contiguous_format, torch.channels_last]
# chip_smoke.py phase 39's shapes: (what, (N, C, H, W), groups, unaligned)
PHASE_39 = [(f"celeba128 b{b} {c}@{side}^2", (b, c, side, side), 8, False)
            for b in (128, 256) for c, side in GROUP_NORM_BLOCKS]
PHASE_39 += GROUP_NORM_OTHER
# the conv bias on the card: (what, (N, C, H, W), unaligned, layout), the
# celeba128 shapes, a ragged, an unaligned one and pose256's (whose NHWC
# runs are too long to stage) in both pairs; C 512 channels_last, which
# the NHWC pair does not take, goes to the NCHW pair as the dispatcher
# sends it
CB_SHAPES = [(f"celeba128 b128 {c}@{side}^2", (128, c, side, side), False)
             for c, side in GROUP_NORM_BLOCKS]
CB_SHAPES += [("ragged 13x29, C/G 3", (6, 24, 13, 29), False),
              ("unaligned 32@16^2", (4, 32, 16, 16), True),
              ("read twice 32@256^2", (4, 32, 256, 256), False)]
CB_CASES = [(what, shape, unaligned, layout)
            for what, shape, unaligned in CB_SHAPES
            for layout in ("nchw", "channels_last")]
CB_CASES += [("C 512 at 8^2", (4, 512, 8, 8), False, "channels_last")]


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


def _conv_bias(channels: int, dtype, seed: int = 7,
               device: str = "cpu") -> torch.Tensor:
    """A conv's bias in the compute dtype, about as large as the spread of
    the conv's output, so that the add moves every value."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(channels, generator=gen, device=device).to(dtype)


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
@pytest.mark.parametrize("channels,groups", [(8, 8), (32, 8), (32, 1)],
                         ids=["cg1", "cg4", "cg32"])
def test_cpu_dispatch_of_channels_last_is_the_nchw_result_bit_for_bit(
        channels, groups, dtype):
    norm = _norm(channels, groups)
    x = _x((3, channels, 6, 5), dtype)
    g = _x((3, channels, 6, 5), dtype, seed=2)
    xn = x.clone().requires_grad_(True)
    xc = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    params = (norm.weight, norm.bias)
    want = group_norm_relu(xn, norm)
    want_grads = torch.autograd.grad(want, (xn, *params), g)
    got = group_norm_relu(xc, norm)
    grads = torch.autograd.grad(
        got, (xc, *params), g.contiguous(memory_format=torch.channels_last))
    assert torch.equal(got, want)
    for a, b in zip(grads, want_grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("conv_bias", [False, True],
                         ids=["no_conv_bias", "conv_bias"])
def test_plain_op_adds_the_conv_bias_then_normalises(conv_bias, dtype):
    """The plain op and the dispatcher on the CPU with a conv bias: the add
    in x's dtype, then the norm, bit for bit, its gradients too (the conv
    bias's in its own dtype); without one, the norm of x; the statistics
    are those of x + conv_bias."""
    norm = _norm(32, 8)
    x = _x((3, 32, 6, 5), dtype).requires_grad_(True)
    g = _x((3, 32, 6, 5), dtype, seed=2)
    cb = _conv_bias(32, dtype).requires_grad_(True) if conv_bias else None
    z = x + cb[:, None, None] if conv_bias else x
    want = F.relu(norm(z))
    inputs = (x, norm.weight, norm.bias, *([cb] if conv_bias else []))
    want_grads = torch.autograd.grad(want, inputs, g)
    for got in (plain(x, 8, norm.weight, norm.bias, 1e-5, cb),
                group_norm_relu(x, norm, cb)):
        assert got.dtype == dtype and torch.equal(got, want)
        grads = torch.autograd.grad(got, inputs, g)
        for a, b in zip(grads, want_grads):
            assert a.dtype == b.dtype and torch.equal(a, b)
    y, mean, rstd = group_norm_relu_stats(x.detach(), 8, norm.weight,
                                          norm.bias, 1e-5, cb)
    y_z, mean_z, rstd_z = group_norm_relu_stats(z.detach(), 8, norm.weight,
                                                norm.bias, 1e-5)
    assert torch.equal(y, want) and torch.equal(y, y_z)
    assert torch.equal(mean, mean_z) and torch.equal(rstd, rstd_z)


@pytest.mark.parametrize("conv_bias", [False, True],
                         ids=["no_conv_bias", "conv_bias"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,groups", [((2, 8, 4, 4), 8),
                                          ((3, 32, 5, 7), 8),
                                          ((1, 16, 3, 3), 1)])
def test_forward_op_passes_opcheck(shape, groups, dtype, layout, conv_bias):
    norm = _norm(shape[1], groups)
    extra = (_conv_bias(shape[1], dtype),) if conv_bias else ()
    torch.library.opcheck(
        gnc.group_norm_relu_op,
        (_x(shape, dtype).contiguous(memory_format=layout),
         norm.weight.detach(), norm.bias.detach(), groups, 1e-5, *extra))


@pytest.mark.parametrize("layout", LAYOUTS, ids=["nchw", "channels_last"])
def test_fake_kernel_keeps_the_input_strides(layout):
    """The op's fake kernel, as an export traces it on CUDA, gives y the
    strides the CUDA kernels give it: x's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty((2, 32, 5, 7), device="cuda", dtype=torch.bfloat16,
                        memory_format=layout)
        w = torch.empty(32, device="cuda")
        y, mean, rstd = gnc.group_norm_relu_op(x, w, w, 8, 1e-5)
    assert y.shape == x.shape and y.stride() == x.stride()
    assert mean.shape == rstd.shape == (2, 8)


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


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("net", ["encoder", "keynet", "decoder"])
def test_blocks_compute_their_former_composition(net, dtype):
    """Encoder, KeyNet and Decoder on the CPU: the blocks' output as when
    each ran F.relu(norm(conv(x))), in NCHW (the CPU path keeps its
    layout), and every parameter's gradient, the conv biases' among them,
    bit for bit: the CPU's conv keeps its bias (a bf16 conv adds it inside
    its float32 sums, so an add after the conv would round twice)."""
    torch.manual_seed(0)
    model = (Encoder(3, (8, 16), (1, 2), groups=4, dtype=dtype)
             if net == "encoder" else
             KeyNet(3, 4, (8, 16), (1, 2), groups=4, dtype=dtype)
             if net == "keynet" else
             Decoder(16, 3, (16, 8), (True, False), groups=4, dtype=dtype))
    with torch.no_grad():
        for conv, _ in (model.trunk if net == "keynet" else model).blocks:
            conv.bias.copy_(_conv_bias(conv.out_channels, torch.float32))
    x = _x((2, 3 if net != "decoder" else 16, 8, 8), torch.float32)
    want = x.to(dtype)
    for conv, norm in (model.trunk if net == "keynet" else model).blocks:
        want = F.relu(norm(conv(want)))
    if net != "encoder":
        want = model.head(want)
    params = list(model.parameters())
    g = _x(want.shape, dtype, seed=4)
    want_grads = torch.autograd.grad(want, params, g)
    got = model(x)
    assert torch.equal(got, want) and got.is_contiguous()
    grads = torch.autograd.grad(got, params, g)
    for (name, _), a, b in zip(model.named_parameters(), grads, want_grads):
        assert torch.equal(a, b), name


def test_channels_last_weight_cast_gives_an_nchw_float32_gradient():
    """The nets' weight cast on CUDA: a channels_last bf16 weight whose
    gradient comes back float32, NCHW, as autograd's own ``.to`` gives its
    values."""
    w = _x((6, 4, 3, 3), torch.float32).requires_grad_(True)
    g = _x((6, 4, 3, 3), torch.bfloat16, seed=5).contiguous(
        memory_format=torch.channels_last)
    cast = nets._CastWeight.apply(w, torch.bfloat16)
    assert cast.dtype == torch.bfloat16
    assert cast.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(cast, w.detach().to(torch.bfloat16))
    got, = torch.autograd.grad(cast, w, g)
    want, = torch.autograd.grad(w.to(torch.bfloat16), w, g)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)
    assert nets.memory_format(w) == torch.preserve_format


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
            "'group_norm_relu_fwd'), g.launches, g.bwd_launches, "
            "g.nhwc_launches, g.nhwc_bwd_launches, g.bias_folds)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "0", "0", "0", "0", "0"]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_cpu_export_answers_as_the_live_model(dtype):
    """An extractor exported on the CPU holds the plain ops (no GroupNorm op
    node; every conv with its bias) and answers as the live extractor, bit
    for bit."""
    cfg = get_config("celeba128").override(**NARROW)
    extractor = export._extractor(cfg, None, "cpu", dtype)
    data = export._export(extractor, cfg, 2, dtype)
    program = torch.export.load(io.BytesIO(data))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert OP not in targets
    assert any("group_norm" in t for t in targets)
    convs = [n for n in program.graph.nodes
             if n.op == "call_function" and "conv" in str(n.target)]
    assert convs and all(len(n.args) > 2 and n.args[2] is not None
                         for n in convs)
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
    traces it: each of Psi's blocks is a conv without its bias and one node
    of the GroupNorm + ReLU op, which takes the bias; no aten GroupNorm,
    ReLU or add is left, and the head's conv keeps its bias."""
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
    calls = [n for n in program.graph.nodes if n.op == "call_function"]
    targets = [str(n.target) for n in calls]
    blocks = len(cfg.model.encoder_filters)
    assert targets.count(OP) == blocks
    assert not [t for t in targets
                if t != OP and ("group_norm" in t or "relu" in t
                                or "add" in t)]
    convs = [n for n in calls if "conv" in str(n.target)]
    assert [len(n.args) > 2 and n.args[2] is not None
            for n in convs] == [False] * blocks + [True]
    ops = [n for n in calls if str(n.target) == OP]
    assert all(n.args[0] is conv for n, conv in zip(ops, convs))
    assert all(isinstance(n.args[5], torch.fx.Node) for n in ops)


# ---- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    return torch.device("cuda")


def _tol(want: torch.Tensor, rtol: float, bf16: bool) -> float:
    top = want.float().abs().max()
    return float(rtol * top + (bf16_ulp(top) if bf16 else 0.0))


def _conv_bias_grad(z, w, b, g, groups):
    """dL/dcb of relu(GroupNorm(x + cb)) in float64: the sum over N, H and W
    of dL/dz at z = x + cb as the kernels form it (rounded to x's dtype)."""
    z = z.double().requires_grad_(True)
    y = F.relu(F.group_norm(z, groups, w.double(), b.double(), 1e-5))
    dz, = torch.autograd.grad(y, z, g.double())
    return dz.sum((0, 2, 3)).float()


def _assert_matches_plain(got, x, w, b, g, groups, dtype, cb=None):
    """Forward (y, mean, rstd) and backward (dx, dgamma, dbeta) of a kernel
    pair against the plain version and its autograd, on x + cb where a conv
    bias cb is given, and then dcb (the sum of dL/dx before its rounding)
    against float64; the tolerances are chip_smoke.py's phase 39's: f32 sums
    in another order, one bf16 spacing (dcb: dbeta's)."""
    x, g = x.contiguous(), g.contiguous()
    if cb is not None:
        x = x + cb[:, None, None]
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = plain(xr, groups, wr, br, 1e-5)
    want = (y.detach(), *group_norm_relu_stats(x, groups, w, b, 1e-5)[1:],
            *torch.autograd.grad(y, (xr, wr, br), g))
    if cb is not None:
        want += (_conv_bias_grad(x, w, b, g, groups),)
    # dx off the ReLU's edge, where two right f32 computations can take
    # different masks, and the most the edge's flips move each gradient
    edge, room = group_norm_relu_edge(x, w, b, g, groups, 1e-5)
    bf16 = dtype == torch.bfloat16
    for name, k, p, rtol, rounded in zip(
            ("y", "mean", "rstd", "dx", "dgamma", "dbeta", "dcb"), got, want,
            (2e-5, 2e-5, 2e-5, 2e-5, 1e-4, 1e-4, 1e-4),
            (bf16, False, False, bf16, False, False, False)):
        assert k.dtype == p.dtype and k.shape == p.shape
        d = (k.float() - p.float()).abs()
        if name == "dx":
            d = d.masked_fill(edge, 0)
        if name in room:
            d = (d - room[name]).clamp_min(0)
        assert d.max() <= _tol(p, rtol, rounded), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("what,shape,groups,unaligned", PHASE_39,
                         ids=[w for w, *_ in PHASE_39])
def test_nhwc_kernels_match_plain_and_rerun_bit_for_bit(
        cuda, what, shape, groups, unaligned, dtype):
    """The NHWC pair on channels_last inputs at every shape of
    chip_smoke.py phase 39: against the plain version, y and dx in x's
    layout, a second run bit for bit."""
    x, w, b, g = group_norm_inputs(shape, dtype, shape[0] + shape[1],
                                   unaligned, channels_last=True)
    counts = (gnc.launches, gnc.bwd_launches, gnc.nhwc_launches,
              gnc.nhwc_bwd_launches)
    runs = []
    for _ in range(2):
        got = gnc.group_norm_relu_fwd_cuda(x, w, b, groups, 1e-5)
        runs.append(got + gnc.group_norm_relu_bwd_cuda(
            g, x, got[1], got[2], w, b, groups))
    assert (gnc.launches - counts[0], gnc.bwd_launches - counts[1],
            gnc.nhwc_launches - counts[2],
            gnc.nhwc_bwd_launches - counts[3]) == (0, 0, 2, 2)
    assert runs[0][0].stride() == runs[0][3].stride() == x.stride()
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    _assert_matches_plain(runs[0], x, w, b, g, groups, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,groups", [
    ((4, 32, 32, 32), 8), ((2, 256, 16, 16), 8), ((3, 24, 13, 29), 8),
    ((5, 8, 9, 9), 8), ((2, 64, 8, 8), 1), ((2, 32, 192, 192), 8)],
    ids=["held", "cg32", "ragged", "cg1", "one_group", "read_twice"])
def test_kernels_match_plain(cuda, shape, groups, dtype):
    """The NCHW pair: forward (y, mean, rstd) and backward (dx, dgamma,
    dbeta) against the plain version and its autograd."""
    norm = _norm(shape[1], groups).to(cuda)
    x, g = _x(shape, dtype).to(cuda), _x(shape, dtype, seed=3).to(cuda)
    w, b = norm.weight.detach(), norm.bias.detach()
    got = gnc.group_norm_relu_fwd_cuda(x, w, b, groups, 1e-5)
    got += gnc.group_norm_relu_bwd_cuda(g, x, got[1], got[2], w, b, groups)
    _assert_matches_plain(got, x, w, b, g, groups, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS, ids=["nchw", "channels_last"])
def test_kernels_are_deterministic_and_counted(cuda, layout):
    """The dispatcher by x's layout: its pair's counters, y and dL/dx in
    x's layout (the incoming NCHW gradient laid out as x first), two runs
    bit for bit."""
    norm = _norm(64, 8).to(cuda)
    x = _x((8, 64, 32, 32), torch.bfloat16).to(cuda).contiguous(
        memory_format=layout).requires_grad_(True)
    g = _x((8, 64, 32, 32), torch.bfloat16, seed=4).to(cuda)
    gnc.launches = gnc.bwd_launches = 0
    gnc.nhwc_launches = gnc.nhwc_bwd_launches = 0
    runs = []
    for _ in range(2):
        y = group_norm_relu(x, norm)
        runs.append((y, *torch.autograd.grad(y, (x, norm.weight, norm.bias),
                                             g)))
    counts = ((gnc.launches, gnc.bwd_launches),
              (gnc.nhwc_launches, gnc.nhwc_bwd_launches))
    nhwc = layout == torch.channels_last
    assert counts == (((0, 0), (2, 2)) if nhwc else ((2, 2), (0, 0)))
    assert runs[0][0].stride() == runs[0][1].stride() == x.stride()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _added(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """x + cb as a conv's in-place bias add writes it, in a tensor of x's
    strides and 16-byte alignment (so the kernels take the same path)."""
    storage = torch.empty(x.untyped_storage().nbytes() // x.element_size(),
                          dtype=x.dtype, device=x.device)
    z = storage.as_strided(x.shape, x.stride(), x.storage_offset())
    return z.copy_(x).add_(cb[:, None, None])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("what,shape,unaligned,layout", CB_CASES,
                         ids=[f"{w} {lay}" for w, _, _, lay in CB_CASES])
def test_conv_bias_folds_into_both_pairs_bit_for_bit(cuda, what, shape,
                                                     unaligned, layout,
                                                     dtype):
    """Both pairs with a conv bias: y, the statistics, dL/dx, dL/dgamma and
    dL/dbeta bit for bit those of aten's add (what a conv's bias add
    writes) then the kernels; all of them against the plain chain, dL/dcb
    against the float64 sum of dL/dz; two runs bit for bit;
    ``bias_folds`` counts the launches that carried the bias, no other."""
    x, w, b, g = group_norm_inputs(shape, dtype, shape[0] + shape[1] + 5,
                                   unaligned,
                                   channels_last=layout == "channels_last")
    if not gnc.nhwc(x):  # as the dispatcher sends it
        x, g = x.contiguous(), g.contiguous()
    cb = _conv_bias(shape[1], dtype, device="cuda")
    z = _added(x, cb)
    folds = gnc.bias_folds
    runs = []
    for _ in range(2):
        got = gnc.group_norm_relu_fwd_cuda(x, w, b, 8, 1e-5, cb)
        runs.append(got + gnc.group_norm_relu_bwd_cuda(
            g, x, got[1], got[2], w, b, 8, cb))
    want = gnc.group_norm_relu_fwd_cuda(z, w, b, 8, 1e-5)
    want += gnc.group_norm_relu_bwd_cuda(g, z, want[1], want[2], w, b, 8)
    assert gnc.bias_folds - folds == 2
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    got = runs[0]
    assert len(got) == 7 and len(want) == 6
    for name, a, c in zip(("y", "mean", "rstd", "dx", "dgamma", "dbeta"),
                          got, want):
        assert torch.equal(a, c), name
    assert got[0].stride() == got[3].stride() == x.stride()
    _assert_matches_plain(got, x, w, b, g, 8, dtype, cb)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS, ids=["nchw", "channels_last"])
@pytest.mark.parametrize("channels", [64, 512])
def test_dispatcher_hands_the_conv_bias_its_gradient(cuda, layout,
                                                     channels):
    """``kernels.group_norm_relu`` with a conv bias cast from a float32
    parameter, as the nets pass it: the kernels' dL/dcb rounded to the
    compute dtype, then float32, reaches the parameter; channels_last 512
    goes to the NCHW pair."""
    norm = _norm(channels, 8).to(cuda)
    x = _x((4, channels, 16, 16), torch.bfloat16).to(cuda).contiguous(
        memory_format=layout).requires_grad_(True)
    g = _x((4, channels, 16, 16), torch.bfloat16, seed=4).to(cuda)
    param = _conv_bias(channels, torch.float32, device="cuda")
    param.requires_grad_(True)
    counts = (gnc.launches, gnc.nhwc_launches, gnc.bias_folds)
    y = group_norm_relu(x, norm, param.to(torch.bfloat16))
    got, = torch.autograd.grad(y, param, g)
    nhwc = layout == torch.channels_last and channels <= gnc.MAX_NHWC_CHANNELS
    assert (gnc.launches - counts[0], gnc.nhwc_launches - counts[1],
            gnc.bias_folds - counts[2]) == ((0, 1, 1) if nhwc else (1, 0, 1))
    xk = x.detach() if nhwc else x.detach().contiguous()
    _, mean, rstd = gnc.group_norm_relu_fwd_cuda(
        xk, norm.weight, norm.bias, 8, 1e-5, param.detach().bfloat16())
    dcb = gnc.group_norm_relu_bwd_cuda(
        g.contiguous(memory_format=gnc._layout(xk)), xk, mean, rstd,
        norm.weight, norm.bias, 8, param.detach().bfloat16())[3]
    assert got.dtype == torch.float32
    assert torch.equal(got, dcb.to(torch.bfloat16).float())


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
    with pytest.raises(ValueError, match="conv_bias"):
        gnc.group_norm_relu_fwd_cuda(x, w, b, 4, 1e-5, w.bfloat16())
    with pytest.raises(ValueError, match=r"conv_bias must be \(8,\)"):
        gnc.group_norm_relu_fwd_cuda(x, w, b, 4, 1e-5, w[:4])
