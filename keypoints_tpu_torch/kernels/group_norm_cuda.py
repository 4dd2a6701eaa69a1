"""Wrappers of the hand-written CUDA GroupNorm + ReLU (``csrc/group_norm.cu``).

Replaces no TPU kernel: the JAX package leaves each conv block's GroupNorm
and ReLU to flax and XLA. On the H100 the eager chain (an upcast, the
moments, the affine, a downcast and the ReLU, and about five passes back)
was the largest share of a train step, so the port gives it one kernel
forward and one backward (PERF.md). :class:`GroupNormReLU` is the
``torch.autograd.Function`` pairing them: it saves ``x`` in its own dtype
and the float32 statistics, and the backward recomputes the normalised
value and the ReLU mask from them; no output and no float32 copy is kept.

Two kernel pairs, chosen by the input's own layout: an NCHW-contiguous
``x`` takes the NCHW pair (``gn_relu_fwd*``, ``gn_relu_bwd``), a
channels_last-contiguous one (the nets' activations on CUDA, where cuDNN's
convs are NHWC kernels) the NHWC pair (``gn_relu_fwd_nhwc``,
``gn_relu_bwd_nhwc``, a cluster of CTAs a sample), with up to
``MAX_NHWC_CHANNELS`` channels (:func:`nhwc`). Outputs and the input's
gradient come back in ``x``'s layout.

Both pairs take the block's conv bias too (``conv_bias``, optional, last):
cuDNN does not fuse it, so PyTorch adds it in a pass of its own and sums its
gradient in another, over an activation these kernels read anyway. With it
they normalise ``z = x + conv_bias`` formed as they load ``x`` (the sum in
float32, rounded once to ``x``'s dtype, so ``z`` is bit for bit what the
add wrote), and the backward also gives ``dL/dconv_bias``, the sum over N,
H and W of ``dL/dz`` (= ``dL/dx``, its float32 values before their
rounding) in a fixed order. ``bias_folds`` counts the forward launches that
carried a conv bias.

The plain PyTorch version is ``keypoints_tpu_torch.ops.group_norm``: the
tests and ``chip_smoke.py`` hold the kernels against it and its autograd.

The forward is also the ``torch.library`` custom op
``keypoints_tpu_torch::group_norm_relu_fwd`` (:func:`group_norm_relu_op`,
registered when this module is imported; the library is built at the first
launch), as K1's forward is, so that ``torch.export`` traces a CUDA
extractor with each block's norm as one node: its CUDA implementation is
:func:`group_norm_relu_fwd_cuda`, its CPU one the plain version with its
statistics (for ``torch.library.opcheck``), its fake one the shapes.
"""

from __future__ import annotations

import ctypes

import torch

from keypoints_tpu_torch.kernels import _build
from keypoints_tpu_torch.ops.group_norm import group_norm_relu_stats

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: bytes of the kernels' vector loads and stores: tensors aligned to them,
#: with H * W a multiple of their elements, take them; others scalar ones
VECTOR_BYTES = 16
#: channels a group at most (the backward keeps per-part sums of a group's
#: channels in 48 KB of shared memory)
MAX_GROUP_CHANNELS = 4096
#: channels at most of a channels_last input (a column of channels a thread)
MAX_NHWC_CHANNELS = 256
#: CTAs a sample at most in the NHWC kernels: the backward's scratch has a
#: row of (N, C) partial sums for each
MAX_NHWC_CLUSTER = 16

#: forward kernel launches so far; the wrapper adds one per launch, nowhere else
launches = 0
#: backward launches so far (the input-gradient kernel and the parameter
#: gradients' reduction, one call)
bwd_launches = 0
#: launches of the NHWC pair so far, forward and backward (counted there,
#: not in ``launches`` and ``bwd_launches``)
nhwc_launches = 0
nhwc_bwd_launches = 0
#: forward launches (either pair) that carried a conv bias
bias_folds = 0

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


def nhwc(x: torch.Tensor) -> bool:
    """Whether ``x`` goes to the NHWC pair: a 4-D channels_last-contiguous
    tensor that is not NCHW-contiguous too (at C = 1 or H * W = 1 the two
    layouts are one and the NCHW pair takes it), of at most
    ``MAX_NHWC_CHANNELS`` channels."""
    return (x.ndim == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)
            and x.shape[1] <= MAX_NHWC_CHANNELS)


def check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          groups: int, what: str,
          conv_bias: torch.Tensor | None = None) -> None:
    """Raise unless the kernels take these: ``x`` a 4-D float32 or
    bfloat16 CUDA tensor, contiguous or taken by the NHWC pair
    (:func:`nhwc`), with C a multiple of ``groups``, at most
    ``MAX_GROUP_CHANNELS`` channels a group and a group of a sample under
    2**31 values; ``weight`` and ``bias`` contiguous float32 ``(C,)`` on
    ``x``'s device, and ``conv_bias``, where given, contiguous ``(C,)`` in
    ``x``'s dtype there."""
    _build.require(x, what, tuple(DTYPES), 4, _layout(x))
    n, c, h, w = x.shape
    if groups < 1 or c % groups:
        raise ValueError(f"{what} needs C a multiple of groups, got C={c}, "
                         f"groups={groups}")
    if c // groups > MAX_GROUP_CHANNELS:
        raise ValueError(f"{what} takes at most {MAX_GROUP_CHANNELS} "
                         f"channels a group, got {c // groups}")
    if h * w < 1 or (c // groups) * h * w >= 2 ** 31 or n * groups >= 2 ** 31:
        raise ValueError(f"{what} takes H*W >= 1, groups of under 2**31 "
                         f"values and N*groups < 2**31, got {tuple(x.shape)}"
                         f" in {groups} groups")
    params = [("weight", weight, torch.float32), ("bias", bias, torch.float32)]
    if conv_bias is not None:
        params.append(("conv_bias", conv_bias, x.dtype))
    for name, t, dtype in params:
        _build.require(t, f"{what} {name}", (dtype,), 1)
        if tuple(t.shape) != (c,) or t.device != x.device:
            raise ValueError(f"{what} {name} must be ({c},) on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def _layout(x: torch.Tensor) -> torch.memory_format:
    return torch.channels_last if nhwc(x) else torch.contiguous_format


def _vec(x: torch.Tensor, *tensors: torch.Tensor) -> int:
    """1 where the vector path holds: the innermost extent (H*W in NCHW, C
    in NHWC) a multiple of a vector's elements and every pointer on a
    vector boundary."""
    per_vector = VECTOR_BYTES // x.element_size()
    inner = x.shape[1] if nhwc(x) else x.shape[2] * x.shape[3]
    return int(inner % per_vector == 0 and all(
        t.data_ptr() % VECTOR_BYTES == 0 for t in (x, *tensors)))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def group_norm_relu_fwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, groups: int, eps: float,
                             conv_bias: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Forward kernel: ``x`` ``(N, C, H, W)`` f32 or bf16 CUDA, contiguous
    (the NCHW kernel) or channels_last (the NHWC one, :func:`nhwc`),
    ``weight`` and ``bias`` (C) f32, optionally the conv's bias ``(C,)`` in
    ``x``'s dtype → ``(y, mean, rstd)``: ``y = relu(GroupNorm(z))`` with
    ``z = x + conv_bias`` (or ``x``) in ``x``'s dtype and layout, ``mean``
    and ``rstd`` ``(N, groups)`` f32, ``z``'s. Launches on the current
    stream and does not synchronise; raises on what the kernel does not take
    (:func:`check`). Carries no gradient: :class:`GroupNormReLU` does."""
    global launches, nhwc_launches, bias_folds
    check(x, weight, bias, groups, "group_norm_relu_fwd_cuda", conv_bias)
    channels_last = nhwc(x)
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((n, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    name = "gn_relu_fwd_nhwc" if channels_last else "gn_relu_fwd"
    fn = _build.entry(f"kp_{name}", _I, _I, _I, _L, _I, _I, _I, _F, _P, _P,
                      _P, _P, _P, _P, _P, _P)
    _build.launch(fn, x, f"{name} ({n}x{c}x{h}x{w}, {groups} groups)",
                  DTYPES[x.dtype], _vec(x, y), _sms(x.device), n, c, groups,
                  h * w, float(eps), x.data_ptr(), weight.data_ptr(),
                  bias.data_ptr(), _ptr(conv_bias), y.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr())
    with _build.lock:
        if channels_last:
            nhwc_launches += 1
        else:
            launches += 1
        if conv_bias is not None:
            bias_folds += 1
    return y, mean, rstd


def group_norm_relu_bwd_cuda(grad: torch.Tensor, x: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             weight: torch.Tensor, bias: torch.Tensor,
                             groups: int,
                             conv_bias: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, ...]:
    """Backward kernels: ``dL/dy`` and ``x`` as for the forward (same shape,
    dtype and layout), the forward's ``mean`` and ``rstd``, ``weight``,
    ``bias`` and ``conv_bias`` → ``(dL/dx, dL/dweight, dL/dbias)``, and
    with a conv bias ``dL/dconv_bias`` fourth: the first in ``x``'s dtype
    and layout (``dL/dx`` is ``dL/dz``), the others f32 (C,), summed over N
    (and H, W) in a fixed order; ``dL/dconv_bias`` sums ``dL/dx``'s float32
    values, before their rounding to ``x``'s dtype."""
    global bwd_launches, nhwc_bwd_launches
    what = "group_norm_relu_bwd_cuda"
    check(x, weight, bias, groups, what, conv_bias)
    channels_last = nhwc(x)
    _build.require(grad, f"{what} grad", (x.dtype,), 4, _layout(x))
    n, c, h, w = x.shape
    if grad.shape != x.shape or grad.device != x.device:
        raise ValueError(f"{what} grad must be {tuple(x.shape)} on "
                         f"{x.device}, got {tuple(grad.shape)} on "
                         f"{grad.device}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        _build.require(t, f"{what} {name}", (torch.float32,), 2)
        if tuple(t.shape) != (n, groups) or t.device != x.device:
            raise ValueError(f"{what} {name} must be ({n}, {groups}) on "
                             f"{x.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    dx = torch.empty_like(x)
    rows = n * MAX_NHWC_CLUSTER if channels_last else n
    # a row's (n, c) partials: dL/dweight's and dL/dbias's, then dL/dcb's
    folded = conv_bias is not None
    part = torch.empty(rows * c * (3 if folded else 2), dtype=torch.float32,
                       device=x.device)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(bias)
    dconv_bias = torch.empty_like(bias) if folded else None
    name = "gn_relu_bwd_nhwc" if channels_last else "gn_relu_bwd"
    fn = _build.entry(f"kp_{name}", _I, _I, _I, _L, _I, _I, _I, _P, _P, _P,
                      _P, _P, _P, _P, _P, _P, _P, _P, _P, _P)
    _build.launch(fn, x, f"{name} ({n}x{c}x{h}x{w}, {groups} groups)",
                  DTYPES[x.dtype], _vec(x, grad, dx), _sms(x.device), n, c,
                  groups, h * w, grad.data_ptr(), x.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
                  bias.data_ptr(), _ptr(conv_bias), dx.data_ptr(),
                  part.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
                  _ptr(dconv_bias))
    with _build.lock:
        if channels_last:
            nhwc_bwd_launches += 1
        else:
            bwd_launches += 1
    if folded:
        return dx, dweight, dbias, dconv_bias
    return dx, dweight, dbias


@torch.library.custom_op("keypoints_tpu_torch::group_norm_relu_fwd",
                         mutates_args=(), device_types="cuda")
def group_norm_relu_op(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, groups: int, eps: float,
                       conv_bias: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel as a custom op: :func:`group_norm_relu_fwd_cuda`
    on CUDA (it raises on what the kernel does not take, and counts the
    launch), the plain version with its statistics on the CPU."""
    return group_norm_relu_fwd_cuda(x, weight, bias, groups, eps, conv_bias)


@group_norm_relu_op.register_kernel("cpu")
def _group_norm_relu_op_cpu(x, weight, bias, groups, eps, conv_bias=None):
    y, mean, rstd = group_norm_relu_stats(x.contiguous(), groups, weight,
                                          bias, eps, conv_bias)
    return torch.empty_like(x).copy_(y), mean, rstd


@group_norm_relu_op.register_fake
def _group_norm_relu_op_fake(x, weight, bias, groups, eps, conv_bias=None):
    """The shapes, and ``y`` in ``x``'s strides, as both kernels give it."""
    stats = x.new_empty((x.shape[0], groups), dtype=torch.float32)
    return torch.empty_like(x), stats, torch.empty_like(stats)


class GroupNormReLU(torch.autograd.Function):
    """``relu(GroupNorm(x + conv_bias))`` with the CUDA forward (through the
    custom op) and the CUDA backward. Saves ``x``, the statistics, the affine
    parameters and the conv bias; the incoming gradient is cast to ``x``'s
    dtype and made contiguous in ``x``'s layout first, and ``dL/dx`` comes
    back in it, ``dL/dconv_bias`` in the conv bias's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, conv_bias):
        y, mean, rstd = group_norm_relu_op(x, weight, bias, int(groups),
                                           float(eps), conv_bias)
        ctx.save_for_backward(x, mean, rstd, weight, bias, conv_bias)
        ctx.groups = int(groups)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, mean, rstd, weight, bias, conv_bias = ctx.saved_tensors
        dx, dweight, dbias, *rest = group_norm_relu_bwd_cuda(
            grad.to(x.dtype).contiguous(memory_format=_layout(x)), x, mean,
            rstd, weight, bias, ctx.groups, conv_bias)
        dconv_bias = rest[0].to(conv_bias.dtype) if rest else None
        return dx, dweight, dbias, None, None, dconv_bias


def group_norm_relu_autograd(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, groups: int, eps: float,
                             conv_bias: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """:class:`GroupNormReLU` applied: the output carries a ``grad_fn``
    whenever ``x``, ``weight``, ``bias`` or ``conv_bias`` requires grad."""
    return GroupNormReLU.apply(x, weight, bias, groups, eps, conv_bias)
