"""VGG feature trunks for the perceptual loss: the port of
``keypoints_tpu/models/vgg.py`` (VGG-16), with VGG-19 beside it.

The torchvision VGG-16 and VGG-19 *features* trunks: conv3×3/ReLU blocks
with 2×2 max pools, run up to the deepest requested tap. A tap is named
``relu3_3`` (VGG-16's, as the JAX package names it: pose256 uses relu1_2,
relu2_2, relu3_3) or with its trunk in front, ``vgg19/relu3_2``; one list
of taps names one trunk. ``input`` (``vgg19/input``) is the normalised
image the trunk receives, in float32. NCHW in and out; the pools are
``kernels.max_pool_2x2`` (the CUDA pool, forward and backward, on CUDA).
Images are RGB in [0, 1] (one channel is repeated to three) and are
normalised with the ImageNet mean and std the torchvision weights expect.

Convs are the port's ``Conv2d``, computing in the compute ``dtype`` as
flax's ``dtype=`` does; the frozen trunk's parameters are cast to it once,
when the trunk is built, and the taps come back in float32. The trunk's
parameters have ``requires_grad=False``: the JAX package closes over them
as constants, so no weight gradient is computed and the target's pass
builds no graph.

Weights: a torchvision ``vgg16`` or ``vgg19`` state dict (``features.N.*``
renamed to the ``convN`` submodules, deeper convs and the classifier
dropped, the trunk loaded strictly), or, with no checkpoint, a fixed init
from ``torch.Generator`` seed 17 with flax's ``nn.Conv`` defaults
(lecun-normal kernels, zero biases). JAX's ``PRNGKey(17)`` draws cannot be
reproduced in torch, so the offline default VGG-16 trunk matches the JAX
package's in distribution, not in value; the tests hold the two packages
to each other on one torchvision-layout file.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from keypoints_tpu_torch.checkpoint import load_checkpoint
from keypoints_tpu_torch.kernels import max_pool_2x2
from keypoints_tpu_torch.models.nets import Conv2d, init_flax_defaults

Layout = list[tuple[int, int, str | None]]

# torchvision vgg16.features index of each conv, its output channels and the
# tap after its ReLU; (-1, 0, name) is a 2x2 max pool
_VGG16_LAYOUT: Layout = [
    (0, 64, "relu1_1"), (2, 64, "relu1_2"), (-1, 0, "pool1"),
    (5, 128, "relu2_1"), (7, 128, "relu2_2"), (-1, 0, "pool2"),
    (10, 256, "relu3_1"), (12, 256, "relu3_2"), (14, 256, "relu3_3"),
    (-1, 0, "pool3"),
    (17, 512, "relu4_1"), (19, 512, "relu4_2"), (21, 512, "relu4_3"),
    (-1, 0, "pool4"),
    (24, 512, "relu5_1"), (26, 512, "relu5_2"), (28, 512, "relu5_3"),
]
# the same for vgg19.features: four convs in each of the last three blocks
_VGG19_LAYOUT: Layout = [
    (0, 64, "relu1_1"), (2, 64, "relu1_2"), (-1, 0, "pool1"),
    (5, 128, "relu2_1"), (7, 128, "relu2_2"), (-1, 0, "pool2"),
    (10, 256, "relu3_1"), (12, 256, "relu3_2"), (14, 256, "relu3_3"),
    (16, 256, "relu3_4"), (-1, 0, "pool3"),
    (19, 512, "relu4_1"), (21, 512, "relu4_2"), (23, 512, "relu4_3"),
    (25, 512, "relu4_4"), (-1, 0, "pool4"),
    (28, 512, "relu5_1"), (30, 512, "relu5_2"), (32, 512, "relu5_3"),
    (34, 512, "relu5_4"),
]
TRUNKS = {"vgg16": _VGG16_LAYOUT, "vgg19": _VGG19_LAYOUT}
#: the trunk of a tap named without one
DEFAULT_TRUNK = "vgg16"
#: the tap of the normalised image itself
INPUT = "input"

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

DEFAULT_LAYERS = ("relu1_2", "relu2_2", "relu3_3")
INIT_SEED = 17      # the JAX package's PRNGKey(17), as a torch seed


def split_taps(layers: Sequence[str]) -> tuple[str, dict[str, str]]:
    """→ (the trunk ``layers`` name, ``{tap as given: its bare name}``).

    A tap is ``name`` (VGG-16's) or ``trunk/name``; every tap of one list
    names the same trunk, and each bare name is ``input`` or a tap of its
    layout."""
    trunks, bare = set(), {}
    for tap in layers:
        trunk, _, name = tap.rpartition("/")
        trunks.add(trunk or DEFAULT_TRUNK)
        bare[tap] = name
    if len(trunks) != 1 or not trunks <= TRUNKS.keys():
        raise ValueError(f"taps {tuple(layers)} must name one trunk of "
                         f"{sorted(TRUNKS)}")
    trunk = trunks.pop()
    known = {name for *_, name in TRUNKS[trunk]} | {INPUT}
    unknown = set(bare.values()) - known
    if unknown:
        raise ValueError(f"unknown {trunk.upper()} taps {sorted(unknown)} in "
                         f"{tuple(layers)}")
    return trunk, bare


def trunk_layout(layers: Sequence[str]) -> Layout:
    """The entries of the trunk's layout that ``layers`` name, up to the
    deepest of them (none for ``input`` alone)."""
    trunk, bare = split_taps(layers)
    layout = TRUNKS[trunk]
    wanted = set(bare.values())
    deepest = max((i for i, (*_, name) in enumerate(layout)
                   if name in wanted), default=-1)
    return layout[:deepest + 1]


class VGGFeatures(nn.Module):
    """Run the trunk on normalised NCHW input → ``{tap: NCHW float32}``,
    keyed by the taps as given."""

    def __init__(self, layers: Sequence[str] = DEFAULT_LAYERS,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.layers = tuple(layers)
        self.trunk, bare = split_taps(self.layers)
        given = {name: tap for tap, name in bare.items()}
        self.input_tap = given.get(INPUT)
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
            self.plan.append((conv, given.get(name)))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        if self.input_tap is not None:
            out[self.input_tap] = x.float()
        x = x.to(self.compute_dtype)
        for conv, tap in self.plan:
            x = max_pool_2x2(x) if conv is None else F.relu(conv(x))
            if tap is not None:
                out[tap] = x.float()
        return out


def torchvision_rename_map(trunk: str = DEFAULT_TRUNK) -> dict[str, str]:
    """torchvision ``vgg16()`` / ``vgg19().features.N`` → the ``convN``
    submodule names."""
    return {f"features.{idx}": f"conv{idx}"
            for idx, _, _ in TRUNKS[trunk] if idx >= 0}


def load_params(model: VGGFeatures, torch_ckpt: str | None = None) -> None:
    """Fill ``model``'s trunk: from a torchvision-layout ``torch_ckpt`` (a
    ``vgg16`` or ``vgg19`` state dict as the trunk is, or a dict holding one
    under ``state_dict``), or with the fixed seeded init.

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
    rename = torchvision_rename_map(model.trunk)
    own = model.state_dict()
    loaded = {}
    for key, value in state.items():
        prefix, _, leaf = key.rpartition(".")
        name = f"{rename.get(prefix, prefix)}.{leaf}"
        if name in own:
            loaded[name] = value
    missing = sorted(own.keys() - loaded.keys())
    if missing:
        raise KeyError(f"{torch_ckpt} lacks the {model.trunk.upper()} trunk "
                       f"parameters {missing} (torchvision names "
                       f"features.N.*)")
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
        model = VGGFeatures(layers, dtype)
    model.to_empty(device="cpu")
    load_params(model, torch_ckpt)
    model = model.to(device).requires_grad_(False).eval()
    for conv in model.children():             # frozen: cast once, not a call
        conv.to(model.compute_dtype)
    mean = torch.tensor(_MEAN, device=device).reshape(3, 1, 1)
    std = torch.tensor(_STD, device=device).reshape(3, 1, 1)

    def features(images: torch.Tensor) -> dict[str, torch.Tensor]:
        if images.shape[1] == 1:                 # grayscale → RGB
            images = images.expand(-1, 3, -1, -1)
        return model((images - mean) / std)

    return features
