"""VGG-16 feature trunk for the perceptual loss — port of ``keypoints_tpu/models/vgg.py``.

The torchvision VGG-16 *features* trunk: conv3×3/ReLU blocks with 2×2
max pools, run up to the deepest requested tap (relu1_2, relu2_2, relu3_3
for pose256). NCHW in and out; the pools are ``kernels.max_pool_2x2`` (the
CUDA pool, forward and backward, on CUDA). Images are RGB in [0, 1] (one
channel is repeated to three) and are normalised with the ImageNet mean and
std the torchvision weights expect.

Convs are the port's ``Conv2d``: float32 parameters cast to the compute
``dtype`` at the call, as flax's ``dtype=`` does; the taps come back in
float32. The trunk's parameters have ``requires_grad=False``: the JAX
package closes over them as constants, so no weight gradient is computed
and the target's pass builds no graph.

Weights: a torchvision ``vgg16`` state dict (``features.N.*`` renamed to the
``convN`` submodules, the classifier dropped, the trunk loaded strictly),
or, with no checkpoint, a fixed init from ``torch.Generator`` seed 17 with
flax's ``nn.Conv`` defaults (lecun-normal kernels, zero biases). JAX's
``PRNGKey(17)`` draws cannot be reproduced in torch, so the offline default
trunk matches the JAX package's in distribution, not in value; the tests
hold the two packages to each other on one torchvision-layout file.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from keypoints_tpu_torch.checkpoint import load_checkpoint
from keypoints_tpu_torch.kernels import max_pool_2x2
from keypoints_tpu_torch.models.nets import Conv2d, init_flax_defaults

# torchvision vgg16.features index of each conv, its output channels and the
# tap after its ReLU; (-1, 0, name) is a 2x2 max pool
_VGG16_LAYOUT: list[tuple[int, int, str | None]] = [
    (0, 64, "relu1_1"), (2, 64, "relu1_2"), (-1, 0, "pool1"),
    (5, 128, "relu2_1"), (7, 128, "relu2_2"), (-1, 0, "pool2"),
    (10, 256, "relu3_1"), (12, 256, "relu3_2"), (14, 256, "relu3_3"),
    (-1, 0, "pool3"),
    (17, 512, "relu4_1"), (19, 512, "relu4_2"), (21, 512, "relu4_3"),
    (-1, 0, "pool4"),
    (24, 512, "relu5_1"), (26, 512, "relu5_2"), (28, 512, "relu5_3"),
]

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

DEFAULT_LAYERS = ("relu1_2", "relu2_2", "relu3_3")
INIT_SEED = 17      # the JAX package's PRNGKey(17), as a torch seed


def trunk_layout(layers: Sequence[str]) -> list[tuple[int, int, str | None]]:
    """The entries of ``_VGG16_LAYOUT`` up to the deepest of ``layers``."""
    unknown = set(layers) - {name for *_, name in _VGG16_LAYOUT}
    if not layers or unknown:
        raise ValueError(f"unknown VGG-16 taps {sorted(unknown)} in "
                         f"{tuple(layers)}")
    deepest = max(i for i, (*_, name) in enumerate(_VGG16_LAYOUT)
                  if name in layers)
    return _VGG16_LAYOUT[:deepest + 1]


class VGG16Features(nn.Module):
    """Run the trunk on normalised NCHW input → ``{tap: NCHW float32}``."""

    def __init__(self, layers: Sequence[str] = DEFAULT_LAYERS,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.layers = tuple(layers)
        self.compute_dtype = dtype or torch.float32
        self.plan: list[tuple[Conv2d | None, str | None]] = []
        cin = 3
        for idx, feats, name in trunk_layout(self.layers):
            conv = None
            if idx >= 0:
                conv = Conv2d(cin, feats, 3, padding=1,
                              dtype=self.compute_dtype)
                self.add_module(f"conv{idx}", conv)
                cin = feats
            self.plan.append((conv, name))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        x = x.to(self.compute_dtype)
        for conv, name in self.plan:
            x = max_pool_2x2(x) if conv is None else F.relu(conv(x))
            if name in self.layers:
                out[name] = x.float()
        return out


def torchvision_rename_map() -> dict[str, str]:
    """torchvision ``vgg16().features.N`` → the ``convN`` submodule names."""
    return {f"features.{idx}": f"conv{idx}"
            for idx, _, _ in _VGG16_LAYOUT if idx >= 0}


def load_params(model: VGG16Features, torch_ckpt: str | None = None) -> None:
    """Fill ``model``'s trunk: from a torchvision-layout ``torch_ckpt`` (a
    ``vgg16`` state dict, or a dict holding one under ``state_dict``), or
    with the fixed seeded init.

    From a file, every conv the trunk has must be there with its shape:
    a missing key raises ``KeyError``, a wrong shape ``ValueError``. Keys of
    deeper convs and of the classifier are dropped.
    """
    if not torch_ckpt:
        init_flax_defaults(model, torch.Generator().manual_seed(INIT_SEED))
        return
    state = load_checkpoint(torch_ckpt)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    rename = torchvision_rename_map()
    own = model.state_dict()
    loaded = {}
    for key, value in state.items():
        prefix, _, leaf = key.rpartition(".")
        name = f"{rename.get(prefix, prefix)}.{leaf}"
        if name in own:
            loaded[name] = value
    missing = sorted(own.keys() - loaded.keys())
    if missing:
        raise KeyError(f"{torch_ckpt} lacks the VGG-16 trunk parameters "
                       f"{missing} (torchvision names features.N.*)")
    for name, value in loaded.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{torch_ckpt}: {name} has shape "
                             f"{tuple(value.shape)}, the trunk needs "
                             f"{tuple(own[name].shape)}")
    model.load_state_dict(loaded, strict=True)


def make_feature_fn(layers: Sequence[str] = DEFAULT_LAYERS,
                    torch_ckpt: str | None = None,
                    dtype: torch.dtype | None = None,
                    device: torch.device | str = "cuda") -> Callable:
    """→ fn(images NCHW in [0, 1]) -> {layer: NCHW float32 features}, with
    the trunk frozen on ``device`` and computing in ``dtype`` (float32 when
    None)."""
    with torch.device("meta"):
        model = VGG16Features(layers, dtype)
    model.to_empty(device="cpu")
    load_params(model, torch_ckpt)
    model = model.to(device).requires_grad_(False).eval()
    mean = torch.tensor(_MEAN, device=device).reshape(3, 1, 1)
    std = torch.tensor(_STD, device=device).reshape(3, 1, 1)

    def features(images: torch.Tensor) -> dict[str, torch.Tensor]:
        if images.shape[1] == 1:                 # grayscale → RGB
            images = images.expand(-1, 3, -1, -1)
        return model((images - mean) / std)

    return features
