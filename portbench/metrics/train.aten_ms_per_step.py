"""Device milliseconds a train step in kernels that are not the program's
own (cuDNN's convs, aten's GroupNorm, casts, elementwise ops and Adam),
over the profiled stretch of replays."""

from portbench.port_kernels import function_of


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps")
    if ctx.get("kind") != "train_replay" or not tr or not steps:
        return None
    total = sum(s for cat, name, s in tr["device"]
                if cat == "kernel" and function_of(name) is None)
    return 1e3 * total / steps if total > 0 else None
