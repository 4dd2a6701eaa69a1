"""The first training steps, in plain PyTorch: pair, forward, loss,
backward and Adam, from the benchmark's own weights and frames.

The rate of update ``n`` (counted from 0) follows a linear warm-up from 0
to the peak over ``warmup_steps`` and a cosine down to a tenth of the peak
at ``steps`` (optax's ``warmup_cosine_decay_schedule``). Adam: b1 0.9,
b2 0.999, eps 1e-8, bias-corrected. The gradient of a batch is summed over
blocks of rows (the loss is a mean over rows, and GroupNorm is per image),
so that a large batch fits beside nothing else.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import augment, model as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


def rate(count: int, opt: dict) -> float:
    peak, warm, total = opt["lr"], opt["warmup_steps"], opt["steps"]
    total = max(total, warm + 1)
    if count < warm:
        return peak * count / warm
    t = min(count - warm, total - warm)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / (total - warm)))
    return peak * (0.9 * cosine + 0.1)


def grads_of_batch(params: dict, spec: dict, images: torch.Tensor,
                   draws: dict, block: int, lowp=None):
    """The batch's loss and the gradient of each parameter, summed over
    blocks of ``block`` rows."""
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
        loss = ref.recon_loss(recon, tgt, spec["loss"])
        share = (rows.stop - rows.start) / n
        g = torch.autograd.grad(loss * share, list(leaves.values()),
                                allow_unused=True)
        for k, gi in zip(leaves, g):
            if gi is not None:
                grads[k] += gi
        total += float(loss.detach()) * share
    return total, grads


def run_steps(params: dict, spec: dict, batches: list, draws: list,
              block: int, lowp=None) -> dict:
    """Take ``len(batches)`` steps from ``params`` → each step's loss, the
    gradient of each leaf of the first two steps, and the parameters after
    the last step."""
    opt = spec["optimizer"]
    p = {k: v.detach().clone().float() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grads = [], []
    for count, (images, d) in enumerate(zip(batches, draws)):
        loss, g = grads_of_batch(p, spec, images, d, block, lowp)
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
