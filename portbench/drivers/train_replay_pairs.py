"""Traffic kind ``train_replay_pairs``: the Transporter's train step,
replayed on temporal frame pairs.

``drivers/train_replay.py``'s protocol on (source, target) pairs in place
of warp pairs. Set-up builds one ``TrainState`` of the program's
Transporter (``training.build_model``, ``model_kind`` transporter) from the
benchmark's weights, a resident uint8 store drawn on the card with its
pair index (episodes of ``episode_frames``, pairs (t, t + ``pair_delta``)
within one: ``data.records.episode_pairs``), and the program's graphed step
(``training.make_graphed_train_step``) over
``train.DeviceResidentBatches`` in temporal mode, rows drawn in the step
with ``data.device.sample_pair_frames``. It takes the first steps (eager,
capture, replays), keeping what the comparison needs, and the window
replays the same object back to back. After the window the program is
freed and the plain Transporter (``portbench.reference.transporter``)
takes the first steps again from the same weights on the same pairs. The
numbers over Psi's leaves alone (``UNJUDGED``) are printed, not judged.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import replay, spec as specs, trace, weights
from portbench.reference import augment, transporter
from portbench.reference.lowp import FP8

#: compare.py's numbers over Psi's leaves alone, printed and not judged.
#: bfloat16's rounding moves near-tied keypoints of Psi's marginal
#: softmaxes on 32x32 maps, and with them Psi's gradient: sound runs read
#: them above the float8 control, so no limit lies between the two
#: readings (PERF.md, section 6)
UNJUDGED = ("grad1.keynet", "grad2.keynet")


def pair_index(spec: dict, device) -> torch.Tensor:
    """The store's (t, t + delta) pairs within each episode, int64 (N, 2)."""
    from keypoints_tpu_torch.data.records import episode_pairs
    n, e = spec["store_frames"], spec["episode_frames"]
    pairs = episode_pairs([e] * (n // e), spec["pair_delta"])
    return torch.from_numpy(pairs.astype(np.int64)).to(device)


def run(ctx: dict) -> dict:
    from keypoints_tpu_torch import train as ptrain
    from keypoints_tpu_torch import training

    spec, traffic, seed, device = (ctx["spec"], ctx["traffic"], ctx["seed"],
                                   ctx["device"])
    hooks = ctx.get("hooks", {})
    model = spec["model"]
    batch = traffic["batch"]
    cfg = specs.program_config(spec, seed)
    got = (cfg.train.model_kind, cfg.data.pair_mode)
    if got != (spec["model_kind"], "temporal"):
        raise SystemExit(f"the program's config trains {got}, the "
                         f"configuration file {spec['model_kind']!r} on "
                         f"temporal pairs")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    params0 = weights.draw(transporter.param_shapes(model), seed,
                           weights.MODEL_SALT, device)
    mark = ctx.get("mark", lambda name: None)
    mark("weights drawn")
    net = training.build_model(cfg, device)
    net.load_state_dict(params0, strict=True)
    state = training.TrainState(net, training.make_optimizer(
        cfg, net.parameters()))
    loss = ptrain.make_loss(cfg, device)
    if "loss" in hooks:
        loss = hooks["loss"](loss)
    if "state" in hooks:
        hooks["state"](state)
    size = model["image_size"]
    store = weights.frames(seed, spec["store_frames"],
                           (model["channels"], size, size), device)
    pairs = pair_index(spec, device)
    mark("model, optimizer and loss built; store and pairs drawn")
    source = ptrain.DeviceResidentBatches(
        SimpleNamespace(frames=store, pairs=pairs), batch, "temporal", seed,
        0)
    step = training.make_graphed_train_step(cfg, state, source, loss=loss)
    call = lambda: step(state)                                # noqa: E731

    n_ref = traffic["reference_steps"]
    prog, metrics = replay.first_steps(call, state, n_ref)
    mark(f"first {n_ref} steps (eager, capture, replays)")
    replayer = replay.Replayer(call, state, traffic["log_every"], device,
                               metrics)
    replayer(n=2)
    float(replayer.metrics["loss"])
    if ctx["trace"]:
        trace.warm_up()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx["t_start"]

    steps, window = replayer(until=ctx["seconds"])
    rate = steps * batch / window
    out = {"setup_s": setup_s, "attempted": steps,
           "e2e": {"train_samples_per_s": rate},
           "layer": {"kind": "train_replay", "rate": rate, "batch": batch,
                     "spec": spec, "steps": 0}}
    if ctx["trace"]:
        k = max(2, math.ceil(traffic["trace_seconds"] * steps / window))
        out["trace"] = trace.profile(lambda: replayer(n=k))
        out["layer"]["steps"] = k
        out["attempted"] += k
    finite = replayer.last_loss_finite()
    peak = torch.cuda.max_memory_reserved(device)
    out["memory_peak_bytes"] = peak
    out["e2e"]["train_peak_gib"] = peak / 2 ** 30

    # the reference's pairs, then the program's state freed
    ij = [pairs.index_select(0, augment.draw_rows(
        seed, s, pairs.shape[0], batch, device)) for s in range(n_ref)]
    rows = [(store.index_select(0, i[:, 0]).clone(),
             store.index_select(0, i[:, 1]).clone()) for i in ij]
    del step, state, net, source, store, pairs, loss, call, replayer, metrics
    gc.collect()
    torch.cuda.empty_cache()
    got = reference_run(spec, traffic, device, params0, rows)
    low = (reference_run(spec, traffic, device, params0, rows, lowp=FP8)
           if ctx.get("control") else None)
    replay.judge(out, prog, got, params0, low)
    for side in ("numbers", "control_numbers"):
        for name in UNJUDGED:
            if side in out:
                print(f"not judged: {side} {name} {out[side].pop(name)!r}",
                      file=sys.stderr)
    out["failed"] = 0 if finite else 1
    out["sound"] = finite
    return out


def reference_run(spec, traffic, device, params0, rows, lowp=None) -> dict:
    """The reference's first steps from ``params0`` on ``rows`` [(source,
    target) uint8]."""
    block = max(1, traffic["reference_pixels_a_block"]
                // spec["model"]["image_size"] ** 2)
    with specs.driver("train_replay").reference_precision():
        pairs = [(s.float() / 255.0, t.float() / 255.0) for s, t in rows]
        return transporter.run_steps(params0, spec, pairs, block, lowp)
