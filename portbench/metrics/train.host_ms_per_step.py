"""Host milliseconds of the program's own work a replayed train step (the
program's ``kp.train_step.prepare`` span: ``TrainStep.prepare`` and the
source's reseed), over the span's own calls in the profiled stretch. The
graph's launch is left out: ``cudaGraphLaunch`` blocks once the launch
queue is full, so its time is the device's step, not the host's."""

from keypoints_tpu_torch.utils import profiling


def read(ctx):
    if ctx.get("kind") != "train_replay":
        return None
    # {} from a program older than its spans, which a traced run may be
    s = getattr(profiling, "span_totals", dict)().get("kp.train_step.prepare")
    return 1e3 * s["seconds"] / s["calls"] if s and s["calls"] else None
