"""Conv stacks Φ (``Encoder``), Ψ (``KeyNet``) and the decoder — port of ``keypoints_tpu/models/nets.py``.

Plain conv3×3 / GroupNorm / ReLU blocks, NCHW (PyTorch's layout; the JAX
package runs NHWC inside and adapts at the model boundary, so the public
layouts agree). Convs use torch's explicit ``padding=1``, the padding the
JAX package spells ``((1, 1), (1, 1))``, never "same".

Submodules are named after the flax parameter paths (``Conv_{i}``,
``GroupNorm_{i}``, ``head``), so the state dict that
``keypoints_tpu.checkpoint.export_torch_state_dict`` writes without a
rename map loads verbatim.

Compute dtype, as flax's ``dtype=`` does it: every parameter is stored in
float32, and each conv casts its input, weight and bias to the module's
compute ``dtype`` at the call (``w.to(dtype)`` is the same tensor when the
dtype already matches, so nothing is launched then; the serving path casts
its conv weights once, at load). GroupNorm keeps float32 parameters and
takes its statistics and affine in float32, returning the input's dtype —
flax 0.12's ``force_float32_reductions``.

A block's GroupNorm and ReLU run as one op, ``kernels.group_norm_relu``:
the GroupNorm + ReLU kernels on CUDA (forward and backward; they keep the
block's ``x`` in its own dtype for the backward, no float32 copy), on the
CPU ``relu(norm(x))`` as composed here, under the same dtype rule.
:class:`GroupNorm` keeps its parameters and its names, so state dicts load
as before, and its own ``forward`` is the norm alone.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from keypoints_tpu_torch.kernels import group_norm_relu

# nearest-up(2x) + conv3x3 == one stride-2 transposed conv with a 4x4 kernel,
# a fixed linear map of the 3x3 one: per axis k4 = A w, with
_UP_A = ((0.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 0.0), (1.0, 0.0, 0.0))


def init_flax_defaults(model: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults on every conv and GroupNorm of ``model``, in module
    order, from ``generator``: lecun-normal conv kernels (normal truncated
    at ±2σ, variance 1/fan_in), zero biases, unit GroupNorm scales."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.GroupNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


class GroupNorm(nn.GroupNorm):
    """GroupNorm in float32 whatever the input dtype; output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return self._conv_forward(x.to(d), self.weight.to(d),
                                  self.bias.to(d))


def _up_taps(w: torch.Tensor, dim: int) -> torch.Tensor:
    """The 3 taps along ``dim`` → the 4 taps ``A w`` of the transposed conv
    (``_UP_A``'s rows are 0/1, so this is adds, exact in any dtype)."""
    w0, w1, w2 = w.unbind(dim)
    return torch.stack([w2, w1 + w2, w0 + w1, w0], dim)


class UpsampleConv(Conv2d):
    """Nearest-×2 upsample + 3×3 conv, as one stride-2 transposed conv.

    ``y = conv_transpose2d(x, k4, stride=2, padding=1)`` with
    ``k4[ci, co, u, v] = Σ_ij A[u, i] A[v, j] w[co, ci, i, j]``, ``A`` =
    ``_UP_A``: the upsampled intermediate never exists. The parameters are
    those of a 3×3 conv (``weight``, ``bias``), so flax and ``export-torch``
    files load. ``k4`` is formed in float32 and cast to ``dtype``, as JAX
    casts its k2. The JAX package's custom VJP (``nets.py:50-92``) works
    around XLA's reverse of the dilated conv's gradient and is not ported:
    autograd's transposed-conv backward is two ordinary convs.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        k4 = _up_taps(_up_taps(self.weight, 2), 3).transpose(0, 1)
        return F.conv_transpose2d(x.to(d), k4.to(d), self.bias.to(d),
                                  stride=2, padding=1)


class Encoder(nn.Module):
    """Φ: image (B, C, H, W) → feature map (B, F, H/2^d, W/2^d).

    ``filters[i]`` with ``strides[i]`` per block; d = number of stride-2 blocks.
    """

    def __init__(self, in_channels: int,
                 filters: Sequence[int] = (32, 32, 64, 64, 128),
                 strides: Sequence[int] = (1, 2, 1, 2, 1), groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.blocks = []
        cin = in_channels
        for i, (f, s) in enumerate(zip(filters, strides)):
            conv = Conv2d(cin, f, 3, stride=s, padding=1, dtype=dtype)
            norm = GroupNorm(min(groups, f), f, eps=1e-5)
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"GroupNorm_{i}", norm)
            self.blocks.append((conv, norm))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for conv, norm in self.blocks:
            x = group_norm_relu(conv(x), norm)
        return x


class KeyNet(nn.Module):
    """Ψ: image (B, C, H, W) → K raw heatmaps (B, K, H/2^d, W/2^d)."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 filters: Sequence[int] = (32, 32, 64, 64, 128),
                 strides: Sequence[int] = (1, 2, 1, 2, 1), groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = Encoder(in_channels, filters, strides, groups, dtype)
        # 1x1 head, no norm/activation — raw logits for the spatial softmax
        self.head = Conv2d(filters[-1], num_keypoints, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x))


class Decoder(nn.Module):
    """Feature map (B, F, h, w) → image (B, C_out, h*2^u, w*2^u).

    Per block an :class:`UpsampleConv` (``upsample[i]``) or a 3×3 conv, then
    GroupNorm and ReLU; then a linear 3×3 head.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 filters: Sequence[int] = (128, 64, 32),
                 upsample: Sequence[bool] = (True, True, False),
                 groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.blocks = []
        cin = in_channels
        for i, (f, up) in enumerate(zip(filters, upsample)):
            conv = (UpsampleConv(cin, f, dtype) if up
                    else Conv2d(cin, f, 3, padding=1, dtype=dtype))
            norm = GroupNorm(min(groups, f), f, eps=1e-5)
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"GroupNorm_{i}", norm)
            self.blocks.append((conv, norm))
            cin = f
        self.head = Conv2d(cin, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for conv, norm in self.blocks:
            x = group_norm_relu(conv(x), norm)
        return self.head(x)
