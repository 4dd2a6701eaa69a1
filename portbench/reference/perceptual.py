"""The perceptual reconstruction loss on a VGG-19 trunk, and the first
training steps under it, in plain PyTorch.

Written from the published descriptions for this benchmark, and
independent of the program under test: it imports nothing of it. The
trunk is configuration E of Simonyan & Zisserman (2014, arXiv:1409.1556):
3x3 convs (padding 1) each followed by a ReLU, 64, 64, pool, 128, 128,
pool, 256 x4, pool, 512 x4, pool, 512 x4, with 2x2 max pools of stride 2.
The loss is Chen & Koltun's (2017, arXiv:1707.09405) as Jakab et al. (2018)
use it: at the image itself and at named ReLUs,

    x     = (image - mean) / std           ImageNet's, on [0, 1] RGB images
    tap_l = x ("input"), or the output of ReLU l ("relu3_2": block 3, conv 2)
    loss  = sum_l  mean((tap_l(recon) - tap_l(target))^2)

each tap weighed 1.

The trunk runs only up to its deepest tap. Its parameters live in one flat
dict named as a torchvision ``vgg19`` state dict names them
(``features.N.weight`` in OIHW, ``features.N.bias``, N the layer's index in
``features``), so one dict of weights drawn by the benchmark serves both
sides; the trunk is frozen (only the reconstruction gets a gradient).

Everything is computed in float32; ``lowp`` (``portbench.reference.lowp``)
rounds each trunk conv as ``model.conv`` does, so the float8 control
covers the trunk too. The training steps are ``reference/train.py``'s
(blocked gradient, the same rate, Adam) with this loss in place of L2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import augment, model as ref
from portbench.reference.train import B1, B2, EPS, rate

#: configuration E: output channels of each conv, "M" a 2x2 max pool
CONFIG_E = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512, "M", 512, 512, 512, 512]
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
INPUT = "input"


def layout() -> list:
    """[(index in ``features``, output channels or 0 for a pool, name)]: a
    conv and its ReLU take two indices, a pool one."""
    out, idx, block, i = [], 0, 1, 0
    for v in CONFIG_E:
        if v == "M":
            out.append((idx, 0, f"pool{block}"))
            idx, block, i = idx + 1, block + 1, 0
        else:
            i += 1
            out.append((idx, v, f"relu{block}_{i}"))
            idx += 2
    return out


def plan(taps) -> list:
    """The layers of :func:`layout` up to the deepest of ``taps``."""
    entries = layout()
    names = [name for _, _, name in entries]
    unknown = set(taps) - set(names) - {INPUT}
    if unknown:
        raise ValueError(f"no VGG-19 taps {sorted(unknown)}")
    deepest = max((names.index(t) for t in taps if t != INPUT), default=-1)
    return entries[:deepest + 1]


def param_shapes(taps) -> list:
    """(name, shape) of every trunk parameter up to the deepest tap."""
    out, cin = [], 3
    for idx, cout, _ in plan(taps):
        if cout:
            out += [(f"features.{idx}.weight", (cout, cin, 3, 3)),
                    (f"features.{idx}.bias", (cout,))]
            cin = cout
    return out


def features(p: dict, taps, images: torch.Tensor, lowp=None) -> dict:
    """Images (B, 3, H, W) in [0, 1] → ``{tap: (B, C, h, w)}``."""
    mean = torch.tensor(MEAN, device=images.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=images.device).view(1, 3, 1, 1)
    x = (images - mean) / std
    out = {INPUT: x} if INPUT in taps else {}
    for idx, cout, name in plan(taps):
        if cout:
            x = F.relu(ref.conv(x, p[f"features.{idx}.weight"],
                                p[f"features.{idx}.bias"], lowp=lowp))
        else:
            x = F.max_pool2d(x, 2)
        if name in taps:
            out[name] = x
    return out


def perceptual_loss(p: dict, taps, recon: torch.Tensor,
                    tgt: torch.Tensor, lowp=None) -> torch.Tensor:
    """The target's pass keeps no graph."""
    fr = features(p, taps, recon, lowp)
    with torch.no_grad():
        ft = features(p, taps, tgt, lowp)
    total = 0.0
    for tap in taps:
        total = total + torch.mean((fr[tap] - ft[tap]) ** 2)
    return total


def grads_of_batch(params: dict, trunk: dict, spec: dict,
                   images: torch.Tensor, draws: dict, block: int, lowp=None):
    """The batch's loss and the gradient of each parameter, summed over
    blocks of ``block`` rows (the loss is a sum of means over rows, and
    GroupNorm is per image)."""
    n = images.shape[0]
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = 0.0
    for lo in range(0, n, block):
        rows = slice(lo, min(n, lo + block))
        src, tgt = augment.make_pair(images[rows], draws, spec["augment"],
                                     rows)
        if lowp is not None:
            src, tgt = lowp.values(src), lowp.values(tgt)
        recon, _ = ref.forward(leaves, spec["model"], src, tgt, lowp)
        loss = perceptual_loss(trunk, spec["perceptual"]["taps"], recon,
                               tgt, lowp)
        share = (rows.stop - rows.start) / n
        g = torch.autograd.grad(loss * share, list(leaves.values()),
                                allow_unused=True)
        for k, gi in zip(leaves, g):
            if gi is not None:
                grads[k] += gi
        total += float(loss.detach()) * share
    return total, grads


def run_steps(params: dict, trunk: dict, spec: dict, batches: list,
              draws: list, block: int, lowp=None) -> dict:
    """Take ``len(batches)`` steps from ``params`` under the perceptual loss
    on ``trunk`` → each step's loss, the gradient of each leaf of the first
    two steps, and the parameters after the last step."""
    opt = spec["optimizer"]
    p = {k: v.detach().clone().float() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grads = [], []
    for count, (images, d) in enumerate(zip(batches, draws)):
        loss, g = grads_of_batch(p, trunk, spec, images, d, block, lowp)
        losses.append(loss)
        if count < 2:
            grads.append({k: t.clone() for k, t in g.items()})
        lr, t = rate(count, opt), count + 1
        with torch.no_grad():
            for k in p:
                m[k].mul_(B1).add_(g[k], alpha=1 - B1)
                v2[k].mul_(B2).addcmul_(g[k], g[k], value=1 - B2)
                mhat = m[k] / (1 - B1 ** t)
                vhat = v2[k] / (1 - B2 ** t)
                p[k] -= lr * mhat / (vhat.sqrt() + EPS)
    return {"losses": losses, "grads": grads, "params": p}
