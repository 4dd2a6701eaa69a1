"""The Transporter cell's yardsticks: its FLOP count against
``FlopCounterMode`` over the plain reference (14.26 GFLOP a training pair
at the published widths), the reference against the program on the CPU at
those widths, the cell's two readers on synthetic layers, its limits
against the numbers its driver judges, and on a card
(marker ``cuda``) the control and a dropped stop-gradient against the
cell's limits."""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import compare, flops_transporter, run, spec, weights
from portbench.reference import transporter as ref

CELL = "transporter128.train_pairs_b64"


def conf():
    return spec.read_json("configs", "transporter128")


def test_training_flops_a_pair():
    c = conf()
    m = c["model"]
    params = {k: torch.empty(s, device="meta").requires_grad_(True)
              for k, s in ref.param_shapes(m)}
    size = m["image_size"]
    src, tgt = (torch.rand((2, m["channels"], size, size), device="meta")
                for _ in range(2))
    with FlopCounterMode(display=False) as counter:
        recon, _ = ref.forward(params, m, src, tgt)
        loss = torch.mean((recon - tgt) ** 2)
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    assert flops_transporter.train_flops(c) == counter.get_total_flops() / 2
    assert flops_transporter.train_flops(c) / 1e9 == pytest.approx(14.26,
                                                                   rel=1e-3)


def test_reference_equals_the_program_at_the_published_widths():
    from keypoints_tpu_torch import training
    c = conf()
    params = weights.draw(ref.param_shapes(c["model"]), 3,
                          weights.MODEL_SALT, "cpu")
    cfg = spec.program_config(c).override(**{"train.compute_dtype":
                                              "float32"})
    net = training.build_model(cfg, "cpu")
    net.load_state_dict(params, strict=True)
    g = torch.Generator().manual_seed(1)
    src, tgt = (torch.rand((1, 3, 128, 128), generator=g) for _ in range(2))
    recon, kp = net(src, tgt)
    torch.mean((recon - tgt) ** 2).backward()
    _, grads = ref.grads_of_batch(params, c, src, tgt, 1)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    r, k = ref.forward(leaves, c["model"], src, tgt)
    torch.testing.assert_close(kp, k.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(recon, r.detach(), rtol=0, atol=1e-5)
    # the keypoint head's bias has a gradient of nought up to rounding
    scale = torch.stack([v.norm() for v in grads.values()]).norm()
    for name, p in net.named_parameters():
        assert (p.grad - grads[name]).norm() <= (
            1e-4 * grads[name].norm() + 1e-6 * scale), name


LAYER = {"kind": "train_replay", "rate": 6000.0, "batch": 64, "steps": 10}


def test_mfu_reads_a_transporter_alone():
    r = spec.metric_reader("transporter.mfu_pct")
    want = 100.0 * 14.257487872e9 * 6000.0 / 989e12
    assert r.read(dict(LAYER, spec=conf())) == pytest.approx(want)
    celeba = spec.read_json("configs", "celeba128")
    assert r.read(dict(LAYER, spec=celeba)) is None
    assert r.read(dict(LAYER, spec=conf(), kind="closed_loop_extract")) \
        is None
    assert r.read({}) is None


def test_kernels_roofline_reads_k3_twice_and_the_backward():
    from portbench import roofline
    r = spec.metric_reader("transporter.kernels_roofline")
    n = 64 * 10
    names = {"void fused_fwd<1>(float const*, int)": (20, 1e-4),
             "void marginal_bwd<2, 8>(float const*)": (10, 2e-5),
             "void gaussian_bwd<4>(float const*)": (10, 3e-5),
             "void warp_field<2>(bf16 const*)": (10, 5e-5),
             "sm90_xmma_fprop": (40, 1e-3)}
    tr = {"seconds_by_name": {k: s for k, (_, s) in names.items()},
          "launches_by_name": {k: n_ for k, (n_, _) in names.items()},
          "device": [], "window_s": 1.0, "busy_s": 0.9}
    bound = (20 * roofline.fused_fwd(n, 32, 32, 32, 32)
             + 10 * roofline.softmax_bwd(n, 32, 32)
             + 10 * roofline.gaussian_bwd(n, 32, 32))
    got = r.read(dict(LAYER, spec=conf(), trace=tr))
    assert got == pytest.approx(100.0 * bound / (1e-4 + 2e-5 + 3e-5))
    celeba = spec.read_json("configs", "celeba128")
    assert r.read(dict(LAYER, spec=celeba, trace=tr)) is None
    assert r.read(dict(LAYER, spec=conf())) is None


def test_the_limits_name_every_number_the_driver_judges():
    leaf = {"keynet.w": 1.0, "encoder.w": 2.0, "decoder.w": 3.0}
    rec = {"losses": [1.0], "grad1": leaf, "grad2": leaf, "change": leaf,
           "diff": {"grad1": leaf, "grad2": leaf, "change": leaf}}
    compared = set(compare.train_numbers(rec, rec))
    unjudged = set(spec.driver("train_replay_pairs").UNJUDGED)
    assert unjudged < compared
    assert set(spec.read_json("limits", CELL)) == compared - unjudged


# --- on a card -----------------------------------------------------------

SMALL = {"config": {"store_frames": 2000, "episode_frames": 100}}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def no_stop_gradient(state):
    """The Transporter's forward with the source branch's stop-gradient
    dropped."""
    from keypoints_tpu_torch.models.nets import f32_nchw
    net = state.model

    def forward(x_s, x_t):
        phi_s = net.encoder(x_s)
        _, g_s = net._heat(x_s)
        phi_t = net.encoder(x_t)
        kp_t, g_t = net._heat(x_t)
        g_s, g_t = g_s.to(phi_t.dtype), g_t.to(phi_t.dtype)
        mixed = (1.0 - g_s) * (1.0 - g_t) * phi_s + g_t * phi_t
        return f32_nchw(net.decoder(mixed)), kp_t

    net.forward = forward


def one_run(seed, hooks=None, control_too=False):
    bench = spec.load()
    line = run.run_cell(bench, spec.cell(bench, CELL), seed, 1.0, False,
                        "cuda", time.perf_counter(), hooks=hooks,
                        control=control_too, overrides=SMALL)
    return line, line.pop("_run")


@pytest.mark.cuda
def test_the_control_fails_the_limits():
    card()
    line, got = one_run(2 ** 31 + 101, control_too=True)
    assert line["correct"] is True, got["numbers"]
    ok, _ = compare.judge(got["control_numbers"],
                          spec.read_json("limits", CELL))
    assert not ok, got["control_numbers"]


@pytest.mark.cuda
def test_a_dropped_stop_gradient_is_not_correct():
    card()
    line, got = one_run(2 ** 31 + 202, hooks={"state": no_stop_gradient})
    assert line["correct"] is False, got["numbers"]
