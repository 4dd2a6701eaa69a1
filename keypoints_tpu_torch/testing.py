"""Seeded inputs shared by the tests and ``chip_smoke.py``.

Parameters and images come from ``np.random.RandomState`` (its stream is
stable across numpy versions), so the same seed gives the same arrays to the
JAX package and to the port, here and on the GPU machine. The committed JAX
references ``tests/data/torch_port_celeba128_extract.json`` and
``tests/data/torch_port_celeba128_train.json`` are made from
``random_flax_params(celeba128, 0)`` and ``random_images(n, celeba128, 1)``;
``tests/data/torch_port_pose256_train.json`` also from
``random_vgg_params(0)``, which both packages read from the file
``write_torchvision_vgg`` writes.
"""

from __future__ import annotations

import base64

import numpy as np
import torch

from keypoints_tpu_torch.checkpoint import state_dict_from_flax
from keypoints_tpu_torch.configs import Config
from keypoints_tpu_torch.data.augment import PairDraws, WarpDraws
from keypoints_tpu_torch.models.vgg import DEFAULT_LAYERS, trunk_layout
from keypoints_tpu_torch.ops.color import JitterFactors


def random_flax_params(cfg: Config, seed: int = 0) -> dict:
    """Autoencoder params of ``cfg`` in flax layout (HWIO kernels), numpy f32.

    → ``{"encoder": {"Conv_i", "GroupNorm_i"}, "keynet": {"trunk": {...},
    "head"}, "decoder": {"Conv_i", "GroupNorm_i", "head"}}``. Kernels have
    variance 1/fan_in; biases and GroupNorm affines are perturbed so every
    parameter matters. The keynet is drawn first, so its values do not
    depend on the rest of the tree.
    """
    rs = np.random.RandomState(seed)

    def draw(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rs.randn(*shape)).astype(np.float32)

    def conv(k, cin, cout, gain=1.0):
        return {"kernel": draw(k, k, cin, cout,
                               scale=gain / np.sqrt(k * k * cin)),
                "bias": draw(cout, scale=0.1)}

    def norm(f):
        return {"scale": draw(f, scale=0.1, offset=1.0),
                "bias": draw(f, scale=0.1)}

    m = cfg.model

    def stack(cin):
        tree = {}
        for i, f in enumerate(m.encoder_filters):
            tree[f"Conv_{i}"] = conv(3, cin, f)
            tree[f"GroupNorm_{i}"] = norm(f)
            cin = f
        return tree

    trunk = stack(cfg.data.channels)
    cin = m.encoder_filters[-1]
    keynet = {"trunk": trunk, "head": conv(1, cin, m.num_keypoints, 0.3)}
    encoder = stack(cfg.data.channels)
    decoder, cin = {}, cin + m.num_keypoints
    for i, f in enumerate(m.decoder_filters):
        decoder[f"Conv_{i}"] = conv(3, cin, f)
        decoder[f"GroupNorm_{i}"] = norm(f)
        cin = f
    decoder["head"] = conv(3, cin, m.out_channels)
    return {"encoder": encoder, "keynet": keynet, "decoder": decoder}


def random_vgg_params(seed: int = 0,
                      layers: tuple[str, ...] = DEFAULT_LAYERS) -> dict:
    """VGG-16 trunk params up to the deepest of ``layers`` in flax layout,
    ``{"conv{idx}": {"kernel" (3, 3, I, O), "bias" (O,)}}``, numpy f32:
    kernels of variance 1/fan_in, biases of std 0.1."""
    rs = np.random.RandomState(seed)
    params, cin = {}, 3
    for idx, feats, _ in trunk_layout(layers):
        if idx < 0:
            continue
        params[f"conv{idx}"] = {
            "kernel": (rs.randn(3, 3, cin, feats) / np.sqrt(9 * cin))
            .astype(np.float32),
            "bias": (0.1 * rs.randn(feats)).astype(np.float32)}
        cin = feats
    return params


def write_torchvision_vgg(params: dict, path) -> None:
    """Save flax-layout VGG params (``random_vgg_params``) as a torchvision
    ``vgg16`` state dict, ``features.{idx}.weight`` (OIHW) and
    ``features.{idx}.bias``, which the loaders of both packages read."""
    state = {f"features.{key[len('conv'):]}": torch.from_numpy(value)
             for key, value in state_dict_from_flax(params).items()}
    torch.save(state, path)


def random_images(n: int, cfg: Config, seed: int = 1) -> np.ndarray:
    """(n, C, S, S) float32 images in [0, 1)."""
    d = cfg.data
    return np.random.RandomState(seed).rand(
        n, d.channels, d.image_size, d.image_size).astype(np.float32)


# The soft-argmax ignores a constant added to a heatmap, so the loss does not
# depend on Ψ's head bias: its exact gradient is 0 and every implementation
# computes rounding noise (~1e-9) there, which Adam's normalisation turns
# into steps of up to the learning rate with either sign.
NOISE_GRADIENT = {"keynet.head.bias"}


def grad_norm_tolerance(want: float, global_norm: float) -> float:
    """How far a parameter's gradient norm may be from a reference's: 1e-3
    of the norm, plus 1e-6 of the global norm for the parameters whose
    gradient is rounding noise."""
    return 1e-3 * want + 1e-6 * global_norm


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits): a bf16
    result rounded once from the same f32 value is within one of it."""
    mag = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def encode_f32(a: np.ndarray) -> str:
    """A float32 array as base64 of its little-endian bytes (exact, compact)."""
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()


def decode_f32(s: str, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), "<f4").reshape(shape).copy()


def reference_draws(ref: dict, device: torch.device | str = "cpu"
                    ) -> list[PairDraws]:
    """Each step's ``PairDraws`` of the committed train reference: the warp
    fields and jitter factors JAX drew (``tests/test_torch_train.py``)."""
    fields = torch.from_numpy(decode_f32(ref["fields"], ref["fields_shape"]))
    out = []
    for i in range(ref["steps"]):
        jit = [JitterFactors(*(torch.tensor(f, dtype=torch.float32)
                               .reshape(-1, 1, 1, 1).to(device)
                               for f in side))
               for side in ref["factors"][i]]
        out.append(PairDraws(fields[i, 0].to(device), fields[i, 1].to(device),
                             jit[0], jit[1]))
    return out


def reference_warp_draws(ref: dict, device: torch.device | str = "cpu"
                         ) -> list[list[WarpDraws]]:
    """Each step's (source, target) ``WarpDraws`` of the committed train
    reference: the TPS noise and affine draws its fields were made from."""
    b = ref["batch"]

    def warp(noise, theta, scale, trans):
        def t(values, shape):
            return torch.tensor(values, dtype=torch.float32).reshape(
                shape).to(device)
        return WarpDraws(t(noise, (b, -1, 2)), t(theta, (b,)),
                         t(scale, (b, 1, 1)), t(trans, (b, 1, 2)))
    return [[warp(*side) for side in step] for step in ref["warp_draws"]]
