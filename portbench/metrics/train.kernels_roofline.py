"""The program's own kernels in the train step against their roofline:
the sum over their launches in the profiled stretch of each launch's least
time at the cell's shapes (``portbench.roofline``: bytes / 3.35e12 or
float32 operations / 67e12, the larger) over the sum of their device time.

A step launches the field warp K5 twice (source and target, bf16 images),
the soft-argmax + raster K3 once, and its backward (K2's, then K1b) once
each. A kernel the stretch does not show is left out of both sums.
"""

from portbench import roofline
from portbench.port_kernels import function_of


def launches(spec, batch):
    """Kernel function -> the least seconds of each of its launches a step."""
    m = spec["model"]
    size, k, c = m["image_size"], m["num_keypoints"], m["channels"]
    side = size
    for s in m["encoder_strides"]:
        side = (side - 1) // s + 1
    n = batch * k
    elem = 2 if spec["compute_dtype"] == "bfloat16" else 4
    return {
        "warp_field": [roofline.warp_field(batch, c, size, size,
                                           spec["augment"]["field_res"],
                                           elem)] * 2,
        "fused_fwd": [roofline.fused_fwd(n, side, side, side, side)],
        "marginal_bwd": [roofline.softmax_bwd(n, side, side)],
        "gaussian_bwd": [roofline.gaussian_bwd(n, side, side)],
    }


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train_replay" or not tr:
        return None
    per_launch = {f: sum(b) / len(b)
                  for f, b in launches(ctx["spec"], ctx["batch"]).items() if b}
    bound = spent = 0.0
    for name, seconds in tr["seconds_by_name"].items():
        f = function_of(name)
        if f in per_launch:
            bound += per_launch[f] * tr["launches_by_name"][name]
            spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
