"""Bulk labelling's share of the card's bf16 peak: Psi's forward FLOPs an
image (``portbench.flops.extract_flops``) x the images a second of the
window / 989e12."""

from portbench.flops import extract_flops
from portbench.peaks import BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "closed_loop_extract" or not ctx.get("rate"):
        return None
    return (100.0 * extract_flops(ctx["spec"]["model"]) * ctx["rate"]
            / BF16_FLOPS)
