"""Wrappers of the hand-written CUDA GroupNorm + ReLU (``csrc/group_norm.cu``).

Replaces no TPU kernel: the JAX package leaves each conv block's GroupNorm
and ReLU to flax and XLA. On the H100 the eager chain (an upcast, the
moments, the affine, a downcast and the ReLU, and about five passes back)
was the largest share of a train step, so the port gives it one kernel
forward and one backward (PERF.md). :class:`GroupNormReLU` is the
``torch.autograd.Function`` pairing them: it saves ``x`` in its own dtype
and the float32 statistics, and the backward recomputes the normalised
value and the ReLU mask from them; no output and no float32 copy is kept.

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

#: forward kernel launches so far; the wrapper adds one per launch, nowhere else
launches = 0
#: backward launches so far (the input-gradient kernel and the parameter
#: gradients' reduction, one call)
bwd_launches = 0

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


def check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          groups: int, what: str) -> None:
    """Raise unless the kernels take these: ``x`` a contiguous 4-D float32
    or bfloat16 CUDA tensor with C a multiple of ``groups``, at most
    ``MAX_GROUP_CHANNELS`` channels a group and a group of a sample under
    2**31 values; ``weight`` and ``bias`` contiguous float32 ``(C,)`` on
    ``x``'s device."""
    _build.require(x, what, tuple(DTYPES), 4)
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
    for name, t in (("weight", weight), ("bias", bias)):
        _build.require(t, f"{what} {name}", (torch.float32,), 1)
        if tuple(t.shape) != (c,) or t.device != x.device:
            raise ValueError(f"{what} {name} must be ({c},) on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def _vec(x: torch.Tensor, *tensors: torch.Tensor) -> int:
    """1 where the vector path holds: H*W a multiple of a vector's elements
    and every pointer on a vector boundary."""
    per_vector = VECTOR_BYTES // x.element_size()
    return int(x.shape[2] * x.shape[3] % per_vector == 0 and all(
        t.data_ptr() % VECTOR_BYTES == 0 for t in (x, *tensors)))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def group_norm_relu_fwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, groups: int, eps: float
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Forward kernel: ``x`` ``(N, C, H, W)`` contiguous f32 or bf16 CUDA,
    ``weight`` and ``bias`` (C) f32 → ``(y, mean, rstd)``: ``y =
    relu(GroupNorm(x))`` in ``x``'s dtype, ``mean`` and ``rstd`` ``(N,
    groups)`` f32. Launches on the current stream and does not synchronise;
    raises on what the kernel does not take (:func:`check`). Carries no
    gradient: :class:`GroupNormReLU` does."""
    global launches
    check(x, weight, bias, groups, "group_norm_relu_fwd_cuda")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((n, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    fn = _build.entry("kp_gn_relu_fwd", _I, _I, _I, _L, _I, _I, _I, _F, _P,
                      _P, _P, _P, _P, _P, _P)
    _build.launch(fn, x, f"gn_relu_fwd ({n}x{c}x{h}x{w}, {groups} groups)",
                  DTYPES[x.dtype], _vec(x, y), _sms(x.device), n, c, groups,
                  h * w, float(eps), x.data_ptr(), weight.data_ptr(),
                  bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
                  rstd.data_ptr())
    with _build.lock:
        launches += 1
    return y, mean, rstd


def group_norm_relu_bwd_cuda(grad: torch.Tensor, x: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             weight: torch.Tensor, bias: torch.Tensor,
                             groups: int
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Backward kernels: ``dL/dy`` and ``x`` as for the forward (same shape
    and dtype), the forward's ``mean`` and ``rstd``, ``weight`` and ``bias``
    → ``(dL/dx, dL/dweight, dL/dbias)``, the first in ``x``'s dtype, the
    others f32 (C,), summed over N in a fixed order."""
    global bwd_launches
    what = "group_norm_relu_bwd_cuda"
    check(x, weight, bias, groups, what)
    _build.require(grad, f"{what} grad", (x.dtype,), 4)
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
    part = torch.empty((n, c, 2), dtype=torch.float32, device=x.device)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(bias)
    fn = _build.entry("kp_gn_relu_bwd", _I, _I, _I, _L, _I, _I, _I, _P, _P,
                      _P, _P, _P, _P, _P, _P, _P, _P, _P)
    _build.launch(fn, x, f"gn_relu_bwd ({n}x{c}x{h}x{w}, {groups} groups)",
                  DTYPES[x.dtype], _vec(x, grad, dx), _sms(x.device), n, c,
                  groups, h * w, grad.data_ptr(), x.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
                  bias.data_ptr(), dx.data_ptr(), part.data_ptr(),
                  dweight.data_ptr(), dbias.data_ptr())
    with _build.lock:
        bwd_launches += 1
    return dx, dweight, dbias


@torch.library.custom_op("keypoints_tpu_torch::group_norm_relu_fwd",
                         mutates_args=(), device_types="cuda")
def group_norm_relu_op(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, groups: int, eps: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel as a custom op: :func:`group_norm_relu_fwd_cuda`
    on CUDA (it raises on what the kernel does not take, and counts the
    launch), the plain version with its statistics on the CPU."""
    return group_norm_relu_fwd_cuda(x, weight, bias, groups, eps)


@group_norm_relu_op.register_kernel("cpu")
def _group_norm_relu_op_cpu(x, weight, bias, groups, eps):
    return group_norm_relu_stats(x, groups, weight, bias, eps)


@group_norm_relu_op.register_fake
def _group_norm_relu_op_fake(x, weight, bias, groups, eps):
    stats = x.new_empty((x.shape[0], groups), dtype=torch.float32)
    return torch.empty_like(x), stats, torch.empty_like(stats)


class GroupNormReLU(torch.autograd.Function):
    """``relu(GroupNorm(x))`` with the CUDA forward (through the custom op)
    and the CUDA backward. Saves ``x``, the statistics and the affine
    parameters; the incoming gradient is cast to ``x``'s dtype and made
    contiguous first."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        y, mean, rstd = group_norm_relu_op(x, weight, bias, int(groups),
                                           float(eps))
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        ctx.groups = int(groups)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, mean, rstd, weight, bias = ctx.saved_tensors
        dx, dweight, dbias = group_norm_relu_bwd_cuda(
            grad.to(x.dtype).contiguous(), x, mean, rstd, weight, bias,
            ctx.groups)
        return dx, dweight, dbias, None, None


def group_norm_relu_autograd(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, groups: int, eps: float
                             ) -> torch.Tensor:
    """:class:`GroupNormReLU` applied: the output carries a ``grad_fn``
    whenever ``x``, ``weight`` or ``bias`` requires grad."""
    return GroupNormReLU.apply(x, weight, bias, groups, eps)
