"""The Transporter of Kulkarni et al. (2019), in plain PyTorch: forward,
loss, gradients and the first Adam steps on (source, target) frame pairs.

Written from the published description (arXiv:1906.11883) for this
benchmark; it imports nothing of the program under test. The trunk, the
keypoint net, the soft-argmax, the Gaussian maps and the up-conv are the
autoencoder reference's (``portbench.reference.model``). Parameters live
in one flat dict under the program's names (``encoder.*``, ``keynet.*``,
``decoder.*``), so one dict of weights drawn by the benchmark serves both.

    phi_s, phi_t = Phi(x_s), Phi(x_t)             conv / GroupNorm / ReLU
    H_x   = max_k Gaussian(soft-argmax(Psi(x)))   (B, 1, h, w)
    phi^  = (1 - H_s)(1 - H_t) sg[phi_s] + H_t phi_t
    x^_t  = decoder(phi^),   loss = mean (x^_t - x_t)^2

The stop-gradient sg[.] is ``detach`` of phi_s and of H_s: no gradient
reaches Phi or Psi through the source frame.

Departures from the paper, each also the program's:

- every conv is 3x3, the first too (the paper's first conv is 7x7);
- GroupNorm of 8 groups where the paper has batch normalisation;
- the decoder upsamples nearest x2, fused into the next conv, where the
  paper resizes bilinearly (computed as ``model.up_conv``'s equal
  stride-2 transposed conv);
- H_x is the max over the K keypoint maps; the paper's combination over
  keypoints was not checked here.

Everything is computed in float32; ``lowp`` turns the same code into the
lower-precision control (``portbench.reference.lowp``), as in the other
references.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import model as ref
from portbench.reference import train as ref_train


def param_shapes(model: dict) -> list:
    """(name, shape) of every parameter of the Transporter ``model`` (the
    ``model`` section of a configuration file), in the program's order."""
    c, k = model["channels"], model["num_keypoints"]
    enc, strides = model["encoder_filters"], model["encoder_strides"]
    out = ref.encoder_shapes("encoder", c, enc, strides)
    out += ref.encoder_shapes("keynet.trunk", c, enc, strides)
    out += [("keynet.head.weight", (k, enc[-1], 1, 1)),
            ("keynet.head.bias", (k,))]
    cin = enc[-1]
    for i, f in enumerate(model["decoder_filters"]):
        out += [(f"decoder.Conv_{i}.weight", (f, cin, 3, 3)),
                (f"decoder.Conv_{i}.bias", (f,)),
                (f"decoder.GroupNorm_{i}.weight", (f,)),
                (f"decoder.GroupNorm_{i}.bias", (f,))]
        cin = f
    out += [("decoder.head.weight", (model["out_channels"], cin, 3, 3)),
            ("decoder.head.bias", (model["out_channels"],))]
    return out


def heat(p: dict, model: dict, x: torch.Tensor, lowp=None):
    """Frames → (keypoints (B, K, 2), attention map H (B, 1, h, w))."""
    hm = ref.keynet(p, model, x, lowp)
    kp = ref.soft_argmax(hm, model["temperature"])
    maps = ref.gaussian(kp, hm.shape[2], hm.shape[3], model["sigma"])
    return kp, maps.amax(1, keepdim=True)


def decoder(p: dict, model: dict, x: torch.Tensor, lowp=None):
    for i, up in enumerate(model["decoder_upsample"]):
        w, b = p[f"decoder.Conv_{i}.weight"], p[f"decoder.Conv_{i}.bias"]
        x = ref.up_conv(x, w, b, lowp) if up else ref.conv(x, w, b, lowp=lowp)
        x = F.group_norm(x, min(model["groups"], w.shape[0]),
                         p[f"decoder.GroupNorm_{i}.weight"],
                         p[f"decoder.GroupNorm_{i}.bias"], eps=1e-5)
        x = F.relu(x)
    return ref.conv(x, p["decoder.head.weight"], p["decoder.head.bias"],
                    lowp=lowp)


def forward(p: dict, model: dict, src: torch.Tensor, tgt: torch.Tensor,
            lowp=None):
    """(source, target) → (reconstruction of the target, its keypoints)."""
    strides, groups = model["encoder_strides"], model["groups"]
    phi_s = ref.trunk(p, "encoder", src, strides, groups, lowp).detach()
    h_s = heat(p, model, src, lowp)[1].detach()
    phi_t = ref.trunk(p, "encoder", tgt, strides, groups, lowp)
    kp_t, h_t = heat(p, model, tgt, lowp)
    transported = (1.0 - h_s) * (1.0 - h_t) * phi_s + h_t * phi_t
    return decoder(p, model, transported, lowp), kp_t


def grads_of_batch(params: dict, spec: dict, src: torch.Tensor,
                   tgt: torch.Tensor, block: int, lowp=None):
    """The batch's loss and each parameter's gradient, summed over blocks
    of ``block`` rows (the loss is a mean over rows; GroupNorm, the
    soft-argmax and the transport are per frame)."""
    n = src.shape[0]
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = 0.0
    for lo in range(0, n, block):
        s, t = src[lo:lo + block], tgt[lo:lo + block]
        if lowp is not None:
            s, t = lowp.values(s), lowp.values(t)
        recon, _ = forward(leaves, spec["model"], s, t, lowp)
        loss = ref.recon_loss(recon, t, spec["loss"])
        share = s.shape[0] / n
        g = torch.autograd.grad(loss * share, list(leaves.values()),
                                allow_unused=True)
        for k, gi in zip(leaves, g):
            if gi is not None:
                grads[k] += gi
        total += float(loss.detach()) * share
    return total, grads


def run_steps(params: dict, spec: dict, pairs: list, block: int,
              lowp=None) -> dict:
    """Take ``len(pairs)`` Adam steps from ``params`` on ``pairs`` [(source,
    target) float32 frames in [0, 1]] → each step's loss, the gradient of
    each leaf of the first two steps, and the parameters after the last
    step. The rate and Adam are ``reference/train.py``'s."""
    opt = spec["optimizer"]
    p = {k: v.detach().clone().float() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grads = [], []
    for count, (src, tgt) in enumerate(pairs):
        loss, g = grads_of_batch(p, spec, src, tgt, block, lowp)
        losses.append(loss)
        if count < 2:
            grads.append({k: t.clone() for k, t in g.items()})
        lr, t = ref_train.rate(count, opt), count + 1
        with torch.no_grad():
            for k in p:
                m[k].mul_(ref_train.B1).add_(g[k], alpha=1 - ref_train.B1)
                v2[k].mul_(ref_train.B2).addcmul_(g[k], g[k],
                                                  value=1 - ref_train.B2)
                mhat = m[k] / (1 - ref_train.B1 ** t)
                vhat = v2[k] / (1 - ref_train.B2 ** t)
                p[k] -= lr * mhat / (vhat.sqrt() + ref_train.EPS)
    return {"losses": losses, "grads": grads, "params": p}
