"""Training entry points — port of ``keypoints_tpu/train.py``.

Only :func:`make_loss` (``train.py:476``) so far; the training loop, its
checkpoints and its CLI come with a later slice.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from keypoints_tpu_torch.configs import Config
from keypoints_tpu_torch.losses import make_perceptual_loss
from keypoints_tpu_torch.models.vgg import make_feature_fn


def make_loss(cfg: Config, device: torch.device | str = "cuda"
              ) -> Optional[Callable]:
    """The reconstruction loss of ``cfg`` for ``make_train_step(cfg,
    loss=...)``: the VGG perceptual loss on ``train.perceptual_layers`` when
    ``train.loss`` is "perceptual", with the trunk on ``device`` computing
    in bf16 when ``train.compute_dtype`` is bfloat16 (the taps and the sum
    stay float32); ``None`` (the L2 default) otherwise.

    The trunk's weights come from ``train.vgg_ckpt``, else from
    ``{data.data_dir}/vgg16.pth`` when that file exists (a torchvision
    ``vgg16`` state dict saved with ``torch.save``), else from the fixed
    seeded init (``models.vgg``).
    """
    if cfg.train.loss != "perceptual":
        return None
    dtype = (torch.bfloat16 if cfg.train.compute_dtype == "bfloat16"
             else None)
    ckpt = cfg.train.vgg_ckpt or None
    if ckpt is None:
        default = os.path.join(cfg.data.data_dir, "vgg16.pth")
        if os.path.exists(default):
            ckpt = default
    if ckpt:
        print(f"perceptual loss: VGG weights from {ckpt}", flush=True)
    layers = tuple(cfg.train.perceptual_layers)
    return make_perceptual_loss(make_feature_fn(layers, ckpt, dtype, device),
                                layers)
