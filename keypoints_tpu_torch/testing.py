"""Seeded inputs shared by the tests and ``chip_smoke.py``.

Parameters and images come from ``np.random.RandomState`` (its stream is
stable across numpy versions), so the same seed gives the same arrays to the
JAX package and to the port, here and on the GPU machine. The committed JAX
references ``tests/data/torch_port_celeba128_extract.json`` and
``tests/data/torch_port_celeba128_train.json`` are made from
``random_flax_params(celeba128, 0)`` and ``random_images(n, celeba128, 1)``;
``tests/data/torch_port_pose256_train.json`` also from
``random_vgg_params(0)``, which both packages read from the file
``write_torchvision_vgg`` writes;
``tests/data/torch_port_transporter_atari_train.json`` from
``random_flax_params(transporter_atari, 0)`` and ``random_images``;
``tests/data/torch_port_celeba128_eval.json`` from
``random_flax_params(celeba128, 0)`` and the faces of its numpy seed
(:func:`reference_eval_batch`).
"""

from __future__ import annotations

import base64

import numpy as np
import torch

from keypoints_tpu_torch.checkpoint import state_dict_from_flax
from keypoints_tpu_torch.configs import Config, get_config
from keypoints_tpu_torch.data.augment import (PairDraws, WarpDraws,
                                              pair_with_positions_from_draws)
from keypoints_tpu_torch.data.faces import render_faces
from keypoints_tpu_torch.models.vgg import DEFAULT_LAYERS, trunk_layout
from keypoints_tpu_torch.ops.color import JitterFactors
from keypoints_tpu_torch.ops.gaussian import gaussian_maps
from keypoints_tpu_torch.ops.spatial_softmax import spatial_softmax
from keypoints_tpu_torch.training import warp_config


def random_flax_params(cfg: Config, seed: int = 0) -> dict:
    """Params of ``cfg``'s model in flax layout (HWIO kernels), numpy f32.

    → ``{"encoder": {"Conv_i", "GroupNorm_i"}, "keynet": {"trunk": {...},
    "head"}, "decoder": {"Conv_i", "GroupNorm_i", "head"}}``, the tree of
    the autoencoder and of the Transporter alike; only the decoder's input
    width differs (the autoencoder's takes the K maps after the features,
    the Transporter's the transported features alone). Kernels have
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
    if cfg.train.model_kind == "autoencoder":
        cin += m.num_keypoints
    decoder = {}
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


def fused_map_tolerance(sigma: float, kp_tol: float = 2e-5) -> float:
    """How far the fused bottleneck's maps may be from the plain version's:
    maps of keypoints within ``kp_tol`` of each other differ by at most
    sqrt(2) ``kp_tol`` times the Gaussian's largest slope e^(-1/2)/sigma
    (6.1 at sigma 0.1, 12.1 at 0.05); that, with a margin of 2."""
    return 2 * np.sqrt(2) * kp_tol * np.exp(-0.5) / sigma


def softmax_grad_tolerance(height: int, width: int) -> float:
    """How far the soft-argmax backward kernel's dL/dheatmaps may be from
    the plain autograd, for an incoming keypoint gradient of order 1: 1e-5
    up to 64 a side (the warp-per-heatmap kernels), growing in proportion to
    the longer side above it, since the softmax's inputs are sums over a side
    (marginal) or over the map (joint) and their rounding grows with the
    number of terms."""
    return 1e-5 * max(1.0, max(height, width) / 64)


def fused_grad_tolerance(x: torch.Tensor, out_height: int, out_width: int,
                         temperature: float, sigma: float, align: bool,
                         variant: str, g_kp: torch.Tensor,
                         g_maps: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on the fused bottleneck's composed backward
    (dL/dheatmaps for dL/dkeypoints ``g_kp`` and dL/dmaps ``g_maps``)
    against the plain autograd. The soft-argmax backward's own bar
    (:func:`softmax_grad_tolerance`, 1e-5 up to 64 a side) for an incoming
    keypoint gradient of order 1, scaled by the size of the one it
    gets here (the raster backward's output, ~50 at the train shapes: a
    linear map's rounding scales with its input); plus the raster
    backward's 1e-4 of its largest keypoint gradient (its sums over Ho*Wo
    run in another order) carried through the soft-argmax's Jacobian
    |dkp_x/dh| + |dkp_y/dh|, which matters where dL/dheatmaps is small: the
    marginal softmax's peaks."""
    xr = x.detach().clone().requires_grad_(True)
    kp = spatial_softmax(xr, temperature, variant, align)
    (jx,) = torch.autograd.grad(kp[..., 0].sum(), xr, retain_graph=True)
    (jy,) = torch.autograd.grad(kp[..., 1].sum(), xr)
    kp = kp.detach().requires_grad_(True)
    (dkp,) = torch.autograd.grad((gaussian_maps(kp, out_height, out_width,
                                                sigma, align)
                                  * g_maps).sum(), kp)
    scale = max(1.0, (dkp + g_kp).abs().max().item())
    return (softmax_grad_tolerance(*x.shape[2:]) * scale
            + 1e-4 * dkp.abs().max() * (jx.abs() + jy.abs()))


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


def reference_eval_batch(ref: dict, device: torch.device | str = "cpu"
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The eval batch of the committed eval reference
    (``tests/test_torch_eval.py``), made by the port from JAX's draws: the
    faces of its numpy seed, paired by the two warp fields and jitter
    factors JAX drew, the landmarks carried into the target. → (src, tgt,
    target positions) on ``device``."""
    cfg = get_config(ref["preset"]).override(**ref["overrides"])
    size = cfg.data.image_size
    imgs, marks = render_faces(ref["batch"], size,
                               np.random.RandomState(ref["numpy_seed"]))
    return pair_with_positions_from_draws(
        torch.from_numpy(imgs).to(device), torch.from_numpy(marks).to(device),
        reference_draws(ref, device)[0], warp_config(cfg))
