"""Model construction and the extraction path — port of parts of ``keypoints_tpu/training.py``.

``build_model`` (``training.py:41``) and ``make_extract_fn`` (``:218``). The
train step, optimizer and loss come with the training slice.

Compute dtype follows ``cfg.train.compute_dtype`` as in JAX: with
"bfloat16" (the serving default) the convs run in bf16, GroupNorm takes its
statistics in float32, and the heatmaps reach the soft-argmax as float32.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from keypoints_tpu_torch.configs import Config
from keypoints_tpu_torch.models import KeypointAutoencoder

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _init_params(model: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults: lecun-normal conv kernels (normal truncated at ±2σ,
    variance 1/fan_in), zero biases, unit GroupNorm scales."""
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


def build_model(cfg: Config,
                device: torch.device | str = "cpu") -> KeypointAutoencoder:
    """The extract model of ``cfg`` on ``device``, random init from seed 0.

    Conv parameters are stored in ``cfg.train.compute_dtype``; GroupNorm
    parameters stay float32.
    """
    if cfg.train.model_kind != "autoencoder":
        raise NotImplementedError(
            f"model_kind {cfg.train.model_kind!r} is not ported yet")
    m = cfg.model
    dtype = COMPUTE_DTYPES[cfg.train.compute_dtype]
    with torch.device("meta"):
        model = KeypointAutoencoder(
            num_keypoints=m.num_keypoints, in_channels=cfg.data.channels,
            temperature=m.temperature, softmax_variant=m.softmax_variant,
            encoder_filters=m.encoder_filters,
            encoder_strides=m.encoder_strides, groups=m.groups)
    model.to_empty(device="cpu")
    _init_params(model, torch.Generator().manual_seed(0))
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            mod.to(dtype)
    return model.to(device).eval().requires_grad_(False)


def make_extract_fn(model: KeypointAutoencoder) -> Callable:
    """Keypoint extraction: NCHW images in [0, 1] → (B, K, 2)."""
    def extract(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model.extract_keypoints(images)
    return extract
