"""The perceptual train step's share of the card's bf16 peak: the model's
FLOPs a sample (``portbench.flops.train_flops``) and the loss's
(``portbench.flops_vgg.loss_flops``: 3 passes of the frozen trunk) x the
samples a second of the window's unprofiled part / 989e12."""

from portbench.flops import train_flops
from portbench.flops_vgg import loss_flops
from portbench.peaks import BF16_FLOPS


def read(ctx):
    spec = ctx.get("spec") or {}
    if (ctx.get("kind") != "train_replay" or not ctx.get("rate")
            or "perceptual" not in spec):
        return None
    flops = train_flops(spec) + loss_flops(spec)
    return 100.0 * flops * ctx["rate"] / BF16_FLOPS
