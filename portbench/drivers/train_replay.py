"""Traffic kind ``train_replay``: the train loop's step, replayed.

Set-up builds one ``TrainState`` from the benchmark's weights, a resident
uint8 store drawn on the card, and the program's graphed step
(``training.make_graphed_train_step``) over an in-step source
(``train.DeviceResidentBatches``, rows drawn in the step with
``data.device.sample_frames``); it takes the first steps (the first eager,
then the capture, then replays), keeping what the comparison needs (each
step's loss, the gradients of the first two steps from Adam's first
moment, the parameters after the steps), and hands that same object to
the window. The window replays it back to back and
reads the metrics every ``log_every`` steps, as the loop does; it ends in a
device synchronise. After the window the program is freed and the
reference takes the first steps again from the same weights and rows.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import torch

from portbench import compare, spec as specs, trace, weights
from portbench.reference import augment, model as ref
from portbench.reference import train as ref_train
from portbench.reference.lowp import FP8

#: Adam's b1: its first moment after update t is b1 m + (1 - b1) g_t
B1 = 0.9


def run(ctx: dict) -> dict:
    from keypoints_tpu_torch import train as ptrain
    from keypoints_tpu_torch import training

    spec, traffic, seed, device = (ctx["spec"], ctx["traffic"], ctx["seed"],
                                   ctx["device"])
    hooks = ctx.get("hooks", {})
    model = spec["model"]
    batch = traffic["batch"]
    cfg = specs.program_config(spec, seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    params0 = weights.draw(ref.param_shapes(model), seed, weights.MODEL_SALT,
                           device)
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
    n_frames = spec["store_frames"]
    size = model["image_size"]
    store = weights.frames(seed, n_frames, (model["channels"], size, size),
                           device)
    mark("model, optimizer and loss built; store drawn")
    source = ptrain.DeviceResidentBatches(
        SimpleNamespace(frames=store, pairs=None), batch, "warp", seed, 0)
    step = training.make_graphed_train_step(cfg, state, source, loss=loss)
    call = lambda: step(state)                                # noqa: E731

    n_ref = traffic["reference_steps"]
    losses, moments = [], []
    for i in range(n_ref):
        _, metrics = call()
        losses.append(float(metrics["loss"]))
        if i < 2:
            moments.append({k: state.optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)).detach().clone()
                for k, p in net.named_parameters()})
    # g_1 = m_1 / (1 - b1); g_2 = (m_2 - b1 m_1) / (1 - b1)
    grads = [{k: m / (1 - B1) for k, m in moments[0].items()},
             {k: (m - B1 * moments[0][k]) / (1 - B1)
              for k, m in moments[1].items()}]
    after = {k: p.detach().clone() for k, p in net.named_parameters()}
    mark(f"first {n_ref} steps (eager, capture, replays)")
    for _ in range(2):
        _, metrics = call()
    float(metrics["loss"])
    if ctx["trace"]:
        trace.warm_up()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx["t_start"]

    log_every, seconds = traffic["log_every"], ctx["seconds"]
    finite = True

    def replay(n=None, until=None):
        nonlocal finite, metrics
        done, t0 = 0, time.perf_counter()
        while True:
            _, metrics = call()
            done += 1
            if state.step % log_every == 0:
                finite &= math.isfinite(float(metrics["loss"]))
            if n is not None and done >= n:
                break
            if until is not None and time.perf_counter() - t0 >= until:
                break
        torch.cuda.synchronize(device)
        return done, time.perf_counter() - t0

    steps, window = replay(until=seconds)
    rate = steps * batch / window
    out = {"setup_s": setup_s, "attempted": steps,
           "e2e": {"train_samples_per_s": rate},
           "layer": {"kind": "train_replay", "rate": rate, "batch": batch,
                     "spec": spec, "steps": 0}}
    if ctx["trace"]:
        k = max(2, math.ceil(traffic["trace_seconds"] * steps / window))
        out["trace"] = trace.profile(lambda: replay(n=k))
        out["layer"]["steps"] = k
        out["attempted"] += k
    finite &= math.isfinite(float(metrics["loss"]))
    peak = torch.cuda.max_memory_reserved(device)
    out["memory_peak_bytes"] = peak
    out["e2e"]["train_peak_gib"] = peak / 2 ** 30

    # the reference's rows, then the program's state freed
    rows = [store.index_select(0, augment.draw_rows(seed, s, n_frames, batch,
                                                    device)).clone()
            for s in range(n_ref)]
    prog = {"losses": losses, "grads": grads, "params": after}
    del step, state, net, source, store, loss, call, metrics, moments
    gc.collect()
    torch.cuda.empty_cache()
    got = reference_run(spec, traffic, seed, device, params0, rows)
    ref_rec = compare.record(got, params0)
    rec = compare.record(prog, params0, got)
    out["numbers"] = compare.train_numbers(rec, ref_rec)
    out["records"] = {"program": rec, "reference": ref_rec}
    print(f"widest leaves: {compare.widest(rec, ref_rec)}", file=sys.stderr)
    if ctx.get("control"):
        low = reference_run(spec, traffic, seed, device, params0, rows,
                            lowp=FP8)
        low_rec = compare.record(low, params0, got)
        out["control_numbers"] = compare.train_numbers(low_rec, ref_rec)
        out["records"]["control"] = low_rec
        print(f"control's widest leaves: {compare.widest(low_rec, ref_rec)}",
              file=sys.stderr)
    out["failed"] = 0 if finite else 1
    out["sound"] = finite
    return out


def reference_run(spec, traffic, seed, device, params0, rows,
                  lowp=None) -> dict:
    """The reference's first steps from ``params0`` on ``rows`` (uint8)."""
    model, batch = spec["model"], traffic["batch"]
    factor_dtype = (torch.bfloat16 if spec["compute_dtype"] == "bfloat16"
                    else torch.float32)
    block = max(1, traffic["reference_pixels_a_block"]
                // model["image_size"] ** 2)
    with reference_precision():
        draws = [augment.draw_pair(seed, s, batch, model["channels"],
                                   spec["augment"], factor_dtype, device)
                 for s in range(len(rows))]
        images = [r.float() / 255.0 for r in rows]
        return ref_train.run_steps(params0, spec, images, draws, block, lowp)


class reference_precision:
    """float32 with TF32 off, for the reference's convs and matmuls."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved

