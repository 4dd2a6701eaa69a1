"""Host milliseconds a bucket call waits for and reads back its answer (the
program's ``kp.extract.read`` span: Psi and K1 still running on the card,
then the device-to-host copy), over the span's own calls in the profiled
stretch."""

from keypoints_tpu_torch.utils import profiling


def read(ctx):
    if ctx.get("kind") != "closed_loop_extract":
        return None
    # {} from a program older than its spans, which a traced run may be
    s = getattr(profiling, "span_totals", dict)().get("kp.extract.read")
    return 1e3 * s["seconds"] / s["calls"] if s and s["calls"] else None
