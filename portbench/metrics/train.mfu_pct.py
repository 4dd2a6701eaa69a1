"""The train step's share of the card's bf16 peak: the model's FLOPs a
sample (``portbench.flops.train_flops``: convs forward and backward) x the
samples a second of the window's unprofiled part / 989e12."""

from portbench.flops import train_flops
from portbench.peaks import BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "train_replay" or not ctx.get("rate"):
        return None
    return 100.0 * train_flops(ctx["spec"]) * ctx["rate"] / BF16_FLOPS
