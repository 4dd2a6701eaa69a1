"""A profiled stretch of a run, reduced to what the metrics read.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (host and device
activity) inside a named range, waits for the device, and reduces the trace
to the stretch's own wall (the range's length on the trace's clock), the
union of the device's busy intervals (kernels, copies and sets) inside it,
device seconds by kernel name, and the longest idle gaps named by what the
host was doing in them.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

MARK = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def union(intervals, lo: float, hi: float) -> list:
    """Merged ``[start, end)`` intervals clipped to ``[lo, hi]``."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                   if e > lo and s < hi)
    merged: list = []
    for s, e in spans:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def gaps(merged: list, lo: float, hi: float) -> list:
    """The idle stretches between merged busy intervals in ``[lo, hi]``."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def reduce(events: list) -> dict:
    """Chrome-trace events (times in us) -> the stretch's numbers in
    seconds; ``None`` when the trace holds no marked range."""
    marks = [e for e in events if e.get("name") == MARK
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    lo = marks[0]["ts"]
    hi = lo + marks[0]["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e.get("ph") == "X" and e["ts"] < hi
              and e["ts"] + e.get("dur", 0) > lo]
    merged = union([(e["ts"], e["ts"] + e["dur"]) for e in device], lo, hi)
    busy = sum(e - s for s, e in merged)
    by_name: dict = {}
    counts: dict = {}
    for e in device:
        name = e["name"]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] * 1e-6
        counts[name] = counts.get(name, 0) + 1
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e.get("ph") == "X" and e.get("name") != MARK]
    idle = []
    for s, e in sorted(gaps(merged, lo, hi), key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        around = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
        what = (min(around, key=lambda h: h["dur"])["name"] if around
                else "no traced host op")
        idle.append([_short(what), (e - s) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "device": [(e["cat"], e["name"], e["dur"] * 1e-6)
                       for e in device],
            "seconds_by_name": by_name, "launches_by_name": counts,
            "device_ops": [[_short(n), s] for n, s in top],
            "idle_gaps": idle}


def _short(name: str) -> str:
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= 160 else name[:157] + "..."


def warm_up() -> None:
    """Start and stop the profiler once, so a later stretch does not pay
    its first start."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile(fn) -> dict:
    """Run ``fn()`` under the profiler inside the marked range, wait for
    the device, and reduce the trace (:func:`reduce`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events)
