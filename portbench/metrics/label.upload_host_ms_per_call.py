"""Host milliseconds a bucket call spends in the frames' upload (the
program's ``kp.extract.upload`` span: ``GraphedBucket.enqueue``'s copy into
the graph's input), over the span's own calls in the profiled stretch."""

from keypoints_tpu_torch.utils import profiling


def read(ctx):
    if ctx.get("kind") != "closed_loop_extract":
        return None
    # {} from a program older than its spans, which a traced run may be
    s = getattr(profiling, "span_totals", dict)().get("kp.extract.upload")
    return 1e3 * s["seconds"] / s["calls"] if s and s["calls"] else None
