"""Device milliseconds of host-to-device copies a bucket call (the frames'
upload into the graph's input), over the profiled stretch of calls."""


def read(ctx):
    tr, calls = ctx.get("trace"), ctx.get("calls")
    if ctx.get("kind") != "closed_loop_extract" or not tr or not calls:
        return None
    total = sum(s for cat, name, s in tr["device"]
                if cat == "gpu_memcpy" and "HtoD" in name)
    return 1e3 * total / calls if total > 0 else None
