"""Device idle share of the train step: 100 x (1 - the union of the
device's busy intervals over the profiled stretch of replays / the
stretch's own wall)."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train_replay" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
