"""Device idle share of bulk labelling: 100 x (1 - the union of the
device's busy intervals over a profiled stretch of bucket calls / the
stretch's own wall)."""


def read(ctx):
    tr = ctx.get("trace")
    if (ctx.get("kind") != "closed_loop_extract" or not tr
            or tr["window_s"] <= 0):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
