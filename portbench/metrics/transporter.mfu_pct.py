"""The Transporter's train step's share of the card's bf16 peak: its FLOPs
a sample (``portbench.flops_transporter.train_flops``: the source's Phi
and Psi forward, the target's Phi, Psi and decoder forward and backward) x
the samples a second of the window's unprofiled part / 989e12. Only a
configuration of ``model_kind`` transporter."""

from portbench.flops_transporter import train_flops
from portbench.peaks import BF16_FLOPS


def read(ctx):
    spec = ctx.get("spec") or {}
    if (ctx.get("kind") != "train_replay" or not ctx.get("rate")
            or spec.get("model_kind") != "transporter"):
        return None
    return 100.0 * train_flops(spec) * ctx["rate"] / BF16_FLOPS
