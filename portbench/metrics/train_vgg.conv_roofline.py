"""The step's convolutions against the card's bf16 peak: the conv FLOPs a
step (the model's, ``portbench.flops.train_flops``, and the VGG trunk's,
``portbench.flops_vgg.loss_flops``, x the batch) / 989e12, over the
library's conv kernels' time a step (names holding ``fprop``, ``dgrad``,
``wgrad`` or ``implicit_convolve``). Their layout transposes and bias adds
are other kernels, left out.

Their time a step is their share of the profiled stretch's device busy
time times the stretch's wall a step on the host clock, as
``train_vgg.pool_roofline`` takes K6's."""

from portbench.flops import train_flops
from portbench.flops_vgg import loss_flops
from portbench.peaks import BF16_FLOPS

CONV = ("fprop", "dgrad", "wgrad", "implicit_convolve")


def read(ctx):
    tr, steps, spec = ctx.get("trace"), ctx.get("steps"), ctx.get("spec")
    if (ctx.get("kind") != "train_replay" or not tr or not steps
            or "perceptual" not in (spec or {})):
        return None
    spent = sum(s for cat, name, s in tr["device"]
                if cat == "kernel" and any(k in name for k in CONV))
    if spent <= 0 or tr["busy_s"] <= 0:
        return None
    step_s = spent / tr["busy_s"] * tr["window_s"] / steps
    flops = (train_flops(spec) + loss_flops(spec)) * ctx["batch"]
    return 100.0 * flops / BF16_FLOPS / step_s
