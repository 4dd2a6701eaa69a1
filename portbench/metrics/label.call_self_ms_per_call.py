"""Host milliseconds of ``BucketedExtract``'s own work a request (the
program's ``kp.extract.call`` span less its upload, replay and read: coerce,
the bucket's choice, padding, the split, the slicing), over the span's own
calls in the profiled stretch."""

from keypoints_tpu_torch.utils import profiling


def read(ctx):
    if ctx.get("kind") != "closed_loop_extract":
        return None
    # {} from a program older than its spans, which a traced run may be
    s = getattr(profiling, "span_totals", dict)().get("kp.extract.call")
    return 1e3 * s["self_seconds"] / s["calls"] if s and s["calls"] else None
