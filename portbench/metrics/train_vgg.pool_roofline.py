"""K6, the 2x2 max pool of the VGG trunk, against its roofline: its least
time a step at the trunk's pool shapes (``portbench.roofline_pool``: bytes
/ 3.35e12; the forward twice a pool, on the target and the
reconstruction, the backward once) over its time a step.

Its time a step is its share of the profiled stretch's device busy time
times the stretch's wall a step on the host clock. The graph replays back
to back, so the device is busy through the stretch (idle ~2 %, which this
counts as the kernels' own time); the share holds where a trace's device
clock runs off the host's (a stretch whose device time all read ~2.1x
short on the card), where the device seconds alone would not."""

from portbench import roofline_pool
from portbench.port_kernels import function_of


def read(ctx):
    tr, steps, spec = ctx.get("trace"), ctx.get("steps"), ctx.get("spec")
    if (ctx.get("kind") != "train_replay" or not tr or not steps
            or "perceptual" not in (spec or {})):
        return None
    bound = roofline_pool.launches(spec, ctx["batch"])
    spent = sum(s for name, s in tr["seconds_by_name"].items()
                if function_of(name) in bound)
    if spent <= 0 or tr["busy_s"] <= 0:
        return None
    step_s = spent / tr["busy_s"] * tr["window_s"] / steps
    return 100.0 * sum(sum(b) for b in bound.values()) / step_s
