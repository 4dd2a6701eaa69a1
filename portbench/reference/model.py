"""The keypoint autoencoder of Jakab & Gupta (2018), in plain PyTorch.

Written from the published description for this benchmark, and independent
of the program under test: it imports nothing of it. Parameters live in one
flat dict ``name -> tensor`` whose names follow the flax parameter paths the
program also uses (``encoder.Conv_0.weight``, ``keynet.head.bias``, ...), so
one dict of weights drawn by the benchmark serves both sides.

    fmap  = Phi(source)                   conv3x3 / GroupNorm / ReLU blocks
    hm    = Psi(target)                   the same trunk, then a 1x1 head
    kp    = marginal soft-argmax(hm)      (B, K, 2) as (x, y) in [-1, 1]
    maps  = Gaussian(kp, sigma)           at the feature map's size
    recon = decoder(cat(fmap, maps))      nearest-x2 up + conv3x3 blocks

Everything is computed in float32. ``lowp`` (called on each conv's input
and weight, its ``output`` on the conv's result) turns the same code into
the lower-precision control (``portbench.reference.lowp.FP8``).

One departure from the literal layer: nearest-x2 upsampling followed by a
3x3 conv is computed as the one stride-2 transposed conv with a 4x4 kernel
that equals it (each 4-tap axis is a sum of the 3 taps, exact). The two are
the same linear map; ``tests/test_portbench_reference.py`` holds them to
each other, and the benchmark counts the transposed conv's operations.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

Params = dict
LowP = Optional[Callable[[torch.Tensor], torch.Tensor]]


def encoder_shapes(prefix: str, cin: int, filters, strides) -> list:
    out = []
    for i, f in enumerate(filters):
        out += [(f"{prefix}.Conv_{i}.weight", (f, cin, 3, 3)),
                (f"{prefix}.Conv_{i}.bias", (f,)),
                (f"{prefix}.GroupNorm_{i}.weight", (f,)),
                (f"{prefix}.GroupNorm_{i}.bias", (f,))]
        cin = f
    return out


def param_shapes(model: dict) -> list:
    """(name, shape) of every parameter of the autoencoder ``model`` (the
    ``model`` section of a configuration file)."""
    c, k = model["channels"], model["num_keypoints"]
    enc, strides = model["encoder_filters"], model["encoder_strides"]
    out = encoder_shapes("encoder", c, enc, strides)
    out += encoder_shapes("keynet.trunk", c, enc, strides)
    out += [("keynet.head.weight", (k, enc[-1], 1, 1)),
            ("keynet.head.bias", (k,))]
    cin = enc[-1] + k
    for i, f in enumerate(model["decoder_filters"]):
        out += [(f"decoder.Conv_{i}.weight", (f, cin, 3, 3)),
                (f"decoder.Conv_{i}.bias", (f,)),
                (f"decoder.GroupNorm_{i}.weight", (f,)),
                (f"decoder.GroupNorm_{i}.bias", (f,))]
        cin = f
    out += [("decoder.head.weight", (model["out_channels"], cin, 3, 3)),
            ("decoder.head.bias", (model["out_channels"],))]
    return out


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
         padding: int = 1, lowp: LowP = None) -> torch.Tensor:
    if lowp is None:
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    return lowp.output(F.conv2d(lowp(x), lowp(w), b, stride=stride,
                                padding=padding))


def up_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            lowp: LowP = None) -> torch.Tensor:
    """Nearest-x2 upsample then conv3x3 (padding 1), as the equal stride-2
    transposed conv: along each axis the output's even pixel o = 2i reads
    input rows (i-1, i) with taps (w0, w1 + w2), the odd one o = 2i + 1
    rows (i, i+1) with (w0 + w1, w2)."""
    def taps(t, dim):
        w0, w1, w2 = t.unbind(dim)
        return torch.stack([w2, w1 + w2, w0 + w1, w0], dim)
    k4 = taps(taps(w, 2), 3).transpose(0, 1)
    if lowp is None:
        return F.conv_transpose2d(x, k4, b, stride=2, padding=1)
    return lowp.output(F.conv_transpose2d(lowp(x), lowp(k4), b, stride=2,
                                          padding=1))


def trunk(p: Params, prefix: str, x: torch.Tensor, strides, groups: int,
          lowp: LowP = None) -> torch.Tensor:
    for i, s in enumerate(strides):
        w = p[f"{prefix}.Conv_{i}.weight"]
        x = conv(x, w, p[f"{prefix}.Conv_{i}.bias"], stride=s, lowp=lowp)
        f = w.shape[0]
        x = F.group_norm(x, min(groups, f),
                         p[f"{prefix}.GroupNorm_{i}.weight"],
                         p[f"{prefix}.GroupNorm_{i}.bias"], eps=1e-5)
        x = F.relu(x)
    return x


def keynet(p: Params, model: dict, x: torch.Tensor,
           lowp: LowP = None) -> torch.Tensor:
    """Psi: images (B, C, H, W) -> raw heatmaps (B, K, h, w)."""
    x = trunk(p, "keynet.trunk", x, model["encoder_strides"],
              model["groups"], lowp)
    return conv(x, p["keynet.head.weight"], p["keynet.head.bias"], padding=0,
                lowp=lowp)


def axis(n: int, device) -> torch.Tensor:
    """Pixel centres of an axis of n on [-1, 1] (align_corners=True)."""
    return torch.linspace(-1.0, 1.0, n, device=device, dtype=torch.float32)


def soft_argmax(hm: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Marginal soft-argmax: x from the softmax of the column sums, y from
    that of the row sums. (B, K, h, w) -> (B, K, 2)."""
    px = torch.softmax(hm.sum(2) / temperature, -1)
    py = torch.softmax(hm.sum(3) / temperature, -1)
    xs, ys = axis(hm.shape[3], hm.device), axis(hm.shape[2], hm.device)
    return torch.stack([(px * xs).sum(-1), (py * ys).sum(-1)], -1)


def gaussian(kp: torch.Tensor, h: int, w: int, sigma: float) -> torch.Tensor:
    """(B, K, 2) -> (B, K, h, w) maps exp(-|p - kp|^2 / (2 sigma^2))."""
    inv = 1.0 / (2.0 * sigma * sigma)
    gx = torch.exp(-(axis(w, kp.device) - kp[..., 0:1]) ** 2 * inv)
    gy = torch.exp(-(axis(h, kp.device) - kp[..., 1:2]) ** 2 * inv)
    return gy[..., :, None] * gx[..., None, :]


def extract(p: Params, model: dict, images: torch.Tensor,
            lowp: LowP = None) -> torch.Tensor:
    """Keypoints of float images in [0, 1]: (B, C, H, W) -> (B, K, 2)."""
    return soft_argmax(keynet(p, model, images, lowp), model["temperature"])


def forward(p: Params, model: dict, src: torch.Tensor, tgt: torch.Tensor,
            lowp: LowP = None):
    """(source, target) -> (reconstruction of the target, keypoints)."""
    fmap = trunk(p, "encoder", src, model["encoder_strides"], model["groups"],
                 lowp)
    kp = extract(p, model, tgt, lowp)
    maps = gaussian(kp, fmap.shape[2], fmap.shape[3], model["sigma"])
    x = torch.cat([fmap, maps], 1)
    for i, up in enumerate(model["decoder_upsample"]):
        w, b = p[f"decoder.Conv_{i}.weight"], p[f"decoder.Conv_{i}.bias"]
        x = up_conv(x, w, b, lowp) if up else conv(x, w, b, lowp=lowp)
        x = F.group_norm(x, min(model["groups"], w.shape[0]),
                         p[f"decoder.GroupNorm_{i}.weight"],
                         p[f"decoder.GroupNorm_{i}.bias"], eps=1e-5)
        x = F.relu(x)
    recon = conv(x, p["decoder.head.weight"], p["decoder.head.bias"],
                 lowp=lowp)
    return recon, kp


def recon_loss(recon: torch.Tensor, tgt: torch.Tensor,
               loss: dict) -> torch.Tensor:
    """The reconstruction loss: mean squared error over pixels."""
    if loss["kind"] != "l2":
        raise ValueError(f"the reference has no {loss['kind']!r} loss")
    return torch.mean((recon - tgt) ** 2)
