"""GroupNorm then ReLU — the norm and activation of every conv block of Φ,
Ψ and the decoder (``keypoints_tpu_torch.models.nets``).

The plain version of the CUDA kernels (``keypoints_tpu_torch.kernels
.group_norm_cuda``) and the path for CPU tensors: the statistics and the
affine in float32 whatever the input dtype, one cast back to it, then the
ReLU, as flax 0.12's ``force_float32_reductions`` GroupNorm followed by
``nn.relu`` computes in the JAX package.

``conv_bias`` (optional, ``x``'s dtype): the block's conv bias, added to
``x`` first in ``x``'s dtype, as the conv's own bias add on CUDA, where the
kernels take it in its place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _add_bias(x: torch.Tensor, conv_bias: torch.Tensor | None
              ) -> torch.Tensor:
    return x if conv_bias is None else x + conv_bias[:, None, None]


def group_norm_relu(x: torch.Tensor, groups: int, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float,
                    conv_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(GroupNorm(x + conv_bias))`` for ``(N, C, H, W)`` ``x``, in
    ``x``'s dtype; ``weight`` and ``bias`` (C) float32, ``conv_bias`` (C)
    in ``x``'s dtype or None."""
    x = _add_bias(x, conv_bias)
    return F.relu(F.group_norm(x.float(), groups, weight, bias,
                               eps).to(x.dtype))


def group_norm_relu_stats(x: torch.Tensor, groups: int, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float,
                          conv_bias: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`group_norm_relu` with the statistics it normalised by: ``(y,
    mean, rstd)``, the last two ``(N, groups)`` float32 (biased variance,
    ``rstd = 1 / sqrt(var + eps)``), what the CUDA forward returns."""
    x = _add_bias(x, conv_bias)
    n, c, h, w = x.shape
    y, mean, rstd = torch.native_group_norm(x.float(), weight, bias, n, c,
                                            h * w, groups, eps)
    return F.relu(y.to(x.dtype)), mean, rstd
