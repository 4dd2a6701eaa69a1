"""The port's Transporter against the benchmark's plain reference
(``portbench/reference/transporter.py``) on the CPU, in float32.

The model is ``training.build_model``'s (``model_kind`` transporter) at the
structure of ``portbench/configs/transporter128.json`` cut to a small
size: 32x32 RGB, widths 8-8-16-16-32-32 at strides 1-1-2-1-2-1 (8x8 maps),
the decoder 32-16-16-8-8, K 3. Weights are the benchmark's draw with the
biases and GroupNorm parameters moved off 0 and 1. Held: the keypoints,
the reconstruction and the loss; every parameter's gradient; two Adam
steps of ``make_train_step`` in temporal mode; and planted faults, each
outside the same tolerances: the stop-gradient dropped, H as the sum over
keypoints, the source frame fed to the target branch. No JAX.
"""

import contextlib
import statistics

import pytest
import torch

from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.kernels import extract_and_render
from keypoints_tpu_torch.models.nets import f32_nchw
from keypoints_tpu_torch.testing import NOISE_GRADIENT, share_cpu_threads
from keypoints_tpu_torch.training import (TrainState, build_model,
                                          make_optimizer, make_train_step)
from portbench import spec as bench_spec
from portbench import weights
from portbench.reference import transporter as ref

share_cpu_threads()

CONF = bench_spec.read_json("configs", "transporter128")
MODEL = dict(CONF["model"], image_size=32, num_keypoints=3,
             encoder_filters=[8, 8, 16, 16, 32, 32],
             decoder_filters=[32, 16, 16, 8, 8])
SPEC = dict(CONF, model=MODEL)
BATCH = 4
#: float32 on both sides, the same operations in another order: the
#: largest gap of an output over its largest value, of a leaf's gradient
#: over the larger of its norm and the median leaf's
RTOL = 2e-5
#: what a planted fault must exceed on at least one number
FAULTS = ("no_stop_gradient", "sum_over_keypoints", "source_as_target")


def small_cfg():
    m = MODEL
    return get_config(CONF["preset"]).override(**{
        "data.channels": m["channels"], "data.image_size": m["image_size"],
        "model.num_keypoints": m["num_keypoints"],
        "model.out_channels": m["out_channels"],
        "model.encoder_filters": m["encoder_filters"],
        "model.encoder_strides": m["encoder_strides"],
        "model.decoder_filters": m["decoder_filters"],
        "model.decoder_upsample": m["decoder_upsample"],
        "train.batch_size": BATCH, "train.compute_dtype": "float32"})


def params(seed=0):
    p = weights.draw(ref.param_shapes(MODEL), seed, weights.MODEL_SALT, "cpu")
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g) if v.ndim == 1
            else v for k, v in p.items()}


def frames(seed):
    size = MODEL["image_size"]
    x = weights.frames(seed, 2 * BATCH, (3, size, size), "cpu").float() / 255
    return x[:BATCH], x[BATCH:]


def port(p):
    net = build_model(small_cfg(), "cpu")
    net.load_state_dict(p, strict=True)
    return net


def forward(net, src, tgt, fault=None):
    """``Transporter.forward`` with one fault planted (None: the port's own
    forward)."""
    if fault is None:
        return net(src, tgt)

    def heat(x):
        if fault != "sum_over_keypoints":
            return net._heat(x)
        hm = f32_nchw(net.keynet(x))
        h, w = hm.shape[2:]
        kp, g = extract_and_render(hm, h, w, net.temperature, net.sigma,
                                   net.softmax_variant, net.align_corners)
        return kp, g.sum(1, keepdim=True)

    grad = fault == "no_stop_gradient"
    with contextlib.nullcontext() if grad else torch.no_grad():
        phi_s = net.encoder(src)
        _, g_s = heat(src)
    x_t = src if fault == "source_as_target" else tgt
    phi_t = net.encoder(x_t)
    kp_t, g_t = heat(x_t)
    transported = (1.0 - g_s) * (1.0 - g_t) * phi_s + g_t * phi_t
    return f32_nchw(net.decoder(transported)), kp_t


def port_grads(p, src, tgt, fault=None):
    net = port(p)
    recon, kp = forward(net, src, tgt, fault)
    loss = torch.mean((recon - tgt) ** 2)
    loss.backward()
    return recon.detach(), kp.detach(), float(loss.detach()), {
        k: q.grad.detach().clone() for k, q in net.named_parameters()}


def leaf_gaps(got: dict, want: dict) -> dict:
    median = statistics.median(float(v.norm()) for v in want.values())
    return {k: float((got[k] - want[k]).norm())
            / max(float(want[k].norm()), median) for k in want}


def gaps(p, src, tgt, fault=None) -> dict:
    """Each compared number's gap from the reference."""
    recon, kp, loss, grads = port_grads(p, src, tgt, fault)
    leaves = {k: q.detach().requires_grad_(True) for k, q in p.items()}
    r_recon, r_kp = (t.detach() for t in ref.forward(leaves, MODEL, src,
                                                      tgt))
    r_loss, r_grads = ref.grads_of_batch(p, SPEC, src, tgt, BATCH)
    return {"recon": float((recon - r_recon).abs().max()
                           / r_recon.abs().max()),
            "keypoints": float((kp - r_kp).abs().max()),
            "loss": abs(loss - r_loss) / r_loss,
            "grads": max(leaf_gaps(grads, r_grads).values())}


def test_the_reference_names_every_parameter_of_the_port():
    net = build_model(small_cfg(), "cpu")
    assert [k for k, _ in ref.param_shapes(MODEL)] == list(net.state_dict())
    assert all(tuple(net.state_dict()[k].shape) == tuple(s)
               for k, s in ref.param_shapes(MODEL))


@pytest.mark.parametrize("seed", [0, 1])
def test_keypoints_reconstruction_loss_and_gradients_match(seed):
    src, tgt = frames(seed)
    got = gaps(params(seed), src, tgt)
    assert all(v <= RTOL for v in got.values()), got


def test_no_gradient_reaches_phi_or_psi_through_the_source_frame():
    """The gradients are the reference's, whose source branch is detached:
    changing the source frame's own path changes no gradient beyond what
    its features change through the transport."""
    p = params(0)
    src, tgt = frames(0)
    _, _, _, grads = port_grads(p, src, tgt)
    _, _, _, wrong = port_grads(p, src, tgt, "no_stop_gradient")
    phi = [k for k in grads if k.startswith("encoder.")]
    assert max(leaf_gaps({k: wrong[k] for k in phi},
                         {k: grads[k] for k in phi}).values()) > 100 * RTOL
    # the decoder sees the same forward either way
    dec = [k for k in grads if k.startswith("decoder.")]
    assert max(leaf_gaps({k: wrong[k] for k in dec},
                         {k: grads[k] for k in dec}).values()) <= RTOL


def test_two_adam_steps_in_temporal_mode_match():
    """``make_train_step`` on (source, target) pairs: the first update's
    rate is 0 (the warm-up), the second moves every parameter."""
    cfg = small_cfg()
    p = params(3)
    pairs = [frames(3), frames(4)]
    net = port(p)
    state = TrainState(net, make_optimizer(cfg, net.parameters()))
    step = make_train_step(cfg)
    losses = []
    for pair in pairs:
        state, metrics = step(state, pair)
        losses.append(float(metrics["loss"]))
    want = ref.run_steps(p, SPEC, pairs, BATCH)
    assert losses == pytest.approx(want["losses"], rel=RTOL)
    lr = cfg.train.lr / cfg.train.warmup_steps
    # leaves whose gradient is nought up to rounding (Psi's head bias; a
    # conv bias under a GroupNorm of one channel a group) move by
    # noise-signed steps: left out, as the benchmark's comparison does
    g2 = {k: float(v.norm()) for k, v in want["grads"][1].items()}
    floor = 1e-3 * statistics.median(g2.values())
    for k, q in net.named_parameters():
        if k in NOISE_GRADIENT or g2[k] < floor:
            continue
        # an Adam step moves each element by about lr; rounding moves it
        # by a few float32 ulps of the weight (one ulp at 0.25 is 1.5e-3 lr)
        gap = float((q.detach() - want["params"][k]).abs().max())
        assert gap <= 1e-2 * lr, (k, gap)
    moved = float((want["params"]["encoder.Conv_0.weight"]
                   - p["encoder.Conv_0.weight"]).abs().median())
    assert moved > 0.1 * lr


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails_the_tolerances(fault):
    src, tgt = frames(0)
    p = params(0)
    assert forward(port(p), src, tgt)[0].equal(
        forward(port(p), src, tgt, None)[0])
    got = gaps(p, src, tgt, fault)
    assert max(got.values()) > 100 * RTOL, got


def test_the_configuration_file_states_the_cut():
    """The program's preset with the file's overrides gives the file's
    widths (``spec.program_config`` stops a run otherwise); the published
    widths are kept and the three cuts listed."""
    cfg = bench_spec.program_config(CONF, seed=7)
    assert (cfg.train.model_kind, cfg.data.pair_mode) == (
        CONF["model_kind"], "temporal")
    assert cfg.train.seed == 7
    assert CONF["model"]["encoder_filters"] == [32, 32, 64, 64, 128, 128]
    assert CONF["model"]["encoder_strides"] == [1, 1, 2, 1, 2, 1]
    assert CONF["reduced"] == ["first_kernel", "norm", "upsample"]
    assert set(CONF["why_reduced"]) == set(CONF["reduced"])
    assert CONF["loss"] == {"kind": "l2"}
    bench = bench_spec.load()
    entry = next(c for c in bench["configs"] if c["name"] == "transporter128")
    assert entry["reduced"] == CONF["reduced"]
    assert entry["source"] == CONF["source"]


def test_an_eager_step_records_the_source_branch_and_the_transport():
    """Under a profiler a step's forward is one ``kp.transporter.source``
    (Phi and Psi on the source frame, its K3 and H) and one
    ``kp.transporter.transport``; the source branch's own convs lie
    inside its span."""
    from torch.profiler import ProfilerActivity, profile
    from keypoints_tpu_torch.utils.profiling import reset_spans, span_totals
    net = port(params(0))
    src, tgt = frames(0)
    reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            recon, _ = net(src, tgt)
            torch.mean((recon - tgt) ** 2).backward()
        totals = span_totals()
    finally:
        reset_spans()
    assert totals["kp.transporter.source"]["calls"] == 1
    assert totals["kp.transporter.transport"]["calls"] == 1
    events = prof.events()
    source = next(e for e in events if e.name == "kp.transporter.source")
    convs = [e for e in events if e.name == "aten::convolution"
             and e.time_range.start >= source.time_range.start
             and e.time_range.end <= source.time_range.end]
    # Phi's six convs, Psi's six and its head
    assert len(convs) == 13
