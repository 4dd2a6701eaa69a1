"""The program's own kernels in the Transporter's train step against their
roofline: the sum over their launches in the profiled stretch of each
launch's least time at the cell's shapes (``portbench.roofline``) over the
sum of their device time. Only a configuration of ``model_kind``
transporter.

A step launches the soft-argmax + raster K3 twice (the source's, forward
only, and the target's), and the target's backward, K2's then K1b, once
each. The field warp K5 is not on this path. A kernel the stretch does not
show is left out of both sums.
"""

from portbench import roofline
from portbench.port_kernels import function_of


def launches(spec, batch):
    """Kernel function -> the least seconds of one of its launches."""
    m = spec["model"]
    side = m["image_size"]
    for s in m["encoder_strides"]:
        side = (side - 1) // s + 1
    n = batch * m["num_keypoints"]
    bwd = "marginal_bwd" if m["softmax_variant"] == "marginal" else "joint_bwd"
    return {"fused_fwd": roofline.fused_fwd(n, side, side, side, side),
            bwd: roofline.softmax_bwd(n, side, side),
            "gaussian_bwd": roofline.gaussian_bwd(n, side, side)}


def read(ctx):
    tr, spec = ctx.get("trace"), ctx.get("spec") or {}
    if (ctx.get("kind") != "train_replay" or not tr
            or spec.get("model_kind") != "transporter"):
        return None
    per_launch = launches(spec, ctx["batch"])
    bound = spent = 0.0
    for name, seconds in tr["seconds_by_name"].items():
        f = function_of(name)
        if f in per_launch:
            bound += per_launch[f] * tr["launches_by_name"][name]
            spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
