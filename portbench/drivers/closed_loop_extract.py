"""Traffic kind ``closed_loop_extract``: bulk labelling through the live
extract.

Set-up builds ``serve.make_live_extract`` on the benchmark's weights at one
bucket and draws a host array of uint8 frames from the seed, and warms the
bucket (its first call answers eagerly and captures its CUDA graph). In the
window one caller hands it successive slices of a bucket's frames, cycling
through the array, each call waiting for its answer (upload, replay, read
back). Every answer of the window is kept and compared with the reference's
keypoints of its slice.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from portbench import compare, spec as specs, trace, weights
from portbench.reference import model as ref
from portbench.reference.extract import keypoints as reference_keypoints
from portbench.traffic_gen import host_frames


def run(ctx: dict) -> dict:
    from keypoints_tpu_torch import serve

    spec, traffic, seed, device = (ctx["spec"], ctx["traffic"], ctx["seed"],
                                   ctx["device"])
    hooks = ctx.get("hooks", {})
    m, b = spec["model"], traffic["batch"]
    cfg = specs.program_config(spec)
    params = weights.draw(ref.param_shapes(m), seed, weights.MODEL_SALT,
                          device)
    mark = ctx.get("mark", lambda name: None)
    mark("weights drawn")
    extract = serve.make_live_extract(cfg, params, batches=(b,),
                                      device=device,
                                      input_dtype=traffic["input_dtype"])
    if "extract" in hooks:
        plain, alter = extract, hooks["extract"]
        extract = lambda x: alter(plain(x))                   # noqa: E731
    frames = host_frames(seed, traffic["frames"],
                         (m["channels"], m["image_size"], m["image_size"]))
    slices = len(frames) // b
    mark("extract built; frames drawn")
    for i in range(traffic["warmup_calls"]):
        extract(frames[(i % slices) * b:(i % slices + 1) * b])
    if ctx["trace"]:
        trace.warm_up()
    setup_s = time.perf_counter() - ctx["t_start"]

    answers: list = []

    def label(n=None, until=None):
        t0 = time.perf_counter()
        while True:
            s = len(answers) % slices
            answers.append((s, extract(frames[s * b:(s + 1) * b])))
            if n is not None and len(answers) >= n:
                break
            if until is not None and time.perf_counter() - t0 >= until:
                break
        return time.perf_counter() - t0

    window = label(until=ctx["seconds"])
    calls = len(answers)
    rate = calls * b / window
    out = {"setup_s": setup_s, "e2e": {"label_images_per_s": rate},
           "layer": {"kind": "closed_loop_extract", "rate": rate, "batch": b,
                     "spec": spec, "calls": 0}}
    if ctx["trace"]:
        k = max(2, math.ceil(traffic["trace_seconds"] * calls / window))
        out["trace"] = trace.profile(lambda: label(n=calls + k))
        out["layer"]["calls"] = k
    out["attempted"] = len(answers) * b
    out["memory_peak_bytes"] = (torch.cuda.max_memory_reserved(device)
                                if device.type == "cuda" else 0)
    del extract
    want = reference_keypoints(spec, params, frames[:slices * b], device)
    want = want.reshape(slices, b, *want.shape[1:])
    got = np.stack([a for _, a in answers])
    which = np.array([s for s, _ in answers])
    out["numbers"] = {"keypoints": compare.keypoint_gap(got, want[which])}
    if ctx.get("control"):
        from portbench.reference.lowp import FP8
        low = reference_keypoints(spec, params, frames[:slices * b], device,
                                  FP8).reshape(want.shape)
        out["control_numbers"] = {"keypoints": compare.keypoint_gap(low,
                                                                     want)}
    print(f"closed loop: {calls} calls of {b} in {window:.3f} s",
          file=sys.stderr)
    out["failed"] = 0
    out["sound"] = True
    return out
