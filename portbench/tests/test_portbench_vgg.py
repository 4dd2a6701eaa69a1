"""The VGG-19 cell's own pieces on the CPU: the trunk's FLOP count against
``FlopCounterMode`` over the reference (36.41 GFLOP a sample at 128x128),
K6's bounds at the trunk's pools, the three readers against synthetic
traces, and the VGG replay's check of the configuration's loss."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, flops_vgg, roofline_pool, spec
from portbench.drivers import train_replay_vgg
from portbench.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from portbench.reference import perceptual

CELL = "celeba128_vgg19.train_b128"


def conf():
    with open(spec.HERE / "configs" / "celeba128_vgg19.json") as f:
        return json.load(f)


def test_the_loss_flops_a_sample_are_three_trunk_passes():
    """The target's and the reconstruction's forward and the input gradient
    of the reconstruction's, as ``FlopCounterMode`` counts them over the
    reference at b2 (the trunk frozen: no weight gradient)."""
    c = conf()
    taps, size = c["perceptual"]["taps"], c["model"]["image_size"]
    trunk = {k: torch.empty(s, device="meta")
             for k, s in perceptual.param_shapes(taps)}
    recon = torch.rand((2, 3, size, size), device="meta", requires_grad=True)
    tgt = torch.rand((2, 3, size, size), device="meta")
    with FlopCounterMode(display=False) as counter:
        loss = perceptual.perceptual_loss(trunk, taps, recon, tgt)
        torch.autograd.grad(loss, [recon])
    assert flops_vgg.loss_flops(c) == counter.get_total_flops() / 2
    assert flops_vgg.loss_flops(c) / 1e9 == pytest.approx(36.41, rel=1e-3)
    assert flops.train_flops(c) / 1e9 == pytest.approx(16.24, rel=1e-3)


def test_pool_bounds_at_the_trunks_four_pools():
    c = conf()
    assert roofline_pool.shapes(c) == [(64, 128, 128), (128, 64, 64),
                                       (256, 32, 32), (512, 16, 16)]
    got = roofline_pool.launches(c, 128)
    assert len(got["max_pool_fwd"]) == 8 and len(got["max_pool_bwd"]) == 4
    x = 128 * 64 * 128 * 128
    assert got["max_pool_fwd"][0] == pytest.approx(
        2 * (x + x / 4) / HBM_BYTES_PER_S)
    assert got["max_pool_bwd"][0] == pytest.approx(
        2 * (2 * x + x / 4) / HBM_BYTES_PER_S)


def trace(names, clock=1.0):
    """A synthetic reduced trace: {kernel name: (seconds, launches)}, its
    device times read at ``clock`` x their length."""
    return {"device": [("kernel", n, clock * s / k)
                       for n, (s, k) in names.items() for _ in range(k)],
            "seconds_by_name": {n: clock * s for n, (s, _) in names.items()},
            "launches_by_name": {n: k for n, (_, k) in names.items()},
            "window_s": 1.0, "busy_s": clock * 0.9}


def ctx(names, steps=2, clock=1.0):
    return {"kind": "train_replay", "spec": conf(), "batch": 128,
            "steps": steps, "rate": 2000.0, "trace": trace(names, clock)}


def synthetic_names(c):
    bound = roofline_pool.launches(c, 128)
    fwd = sum(bound["max_pool_fwd"])             # a step's 8 launches
    bwd = sum(bound["max_pool_bwd"])
    return fwd, bwd, {"void max_pool_fwd<__nv_bfloat16>(int, long long)": (
                 2 * fwd / 0.5, 16),
             "void max_pool_bwd<__nv_bfloat16>(int, long long)": (
                 2 * bwd / 0.25, 8),
             "sm90_xmma_fprop_implicit_gemm_bf16": (0.03, 40),
             "sm90_xmma_dgrad_implicit_gemm_bf16": (0.02, 40),
             "implicit_convolve_sgemm": (0.01, 4),
             "void cudnn::nchwToNhwcKernel": (0.5, 80)}


def test_the_readers_on_a_synthetic_trace():
    c = conf()
    fwd, bwd, names = synthetic_names(c)
    read = {m: spec.metric_reader(m).read(ctx(names))
            for m in ("train_vgg.pool_roofline", "train_vgg.conv_roofline",
                      "train_vgg.mfu_pct")}
    # a step's bound fwd + bwd over its time: the pool's 4 fwd + 8 bwd
    # seconds, a share of the 0.9 s busy, of the 1 s wall over 2 steps
    assert read["train_vgg.pool_roofline"] == pytest.approx(
        100 * (fwd + bwd) * 2 * 0.9 / (4 * fwd + 8 * bwd))
    step_flops = (flops.train_flops(c) + flops_vgg.loss_flops(c)) * 128
    assert read["train_vgg.conv_roofline"] == pytest.approx(
        100 * step_flops / BF16_FLOPS * 2 * 0.9 / 0.06)
    assert read["train_vgg.mfu_pct"] == pytest.approx(
        100 * step_flops / 128 * 2000.0 / BF16_FLOPS)


@pytest.mark.parametrize("metric", ["train_vgg.pool_roofline",
                                    "train_vgg.conv_roofline"])
def test_the_rooflines_hold_where_the_device_clock_runs_short(metric):
    """A trace whose device times all read 2.1x short against the host's
    wall, as one stretch read on the card, reads as the true trace."""
    _, _, names = synthetic_names(conf())
    reader = spec.metric_reader(metric)
    assert reader.read(ctx(names, clock=1 / 2.1)) == pytest.approx(
        reader.read(ctx(names)))


@pytest.mark.parametrize("metric", ["train_vgg.pool_roofline",
                                    "train_vgg.conv_roofline",
                                    "train_vgg.mfu_pct"])
def test_the_readers_read_nothing_outside_the_cell(metric):
    reader = spec.metric_reader(metric)
    assert reader.read({}) is None
    plain = ctx({"sm90_xmma_fprop": (0.03, 40)})
    plain["spec"] = spec.read_json("configs", "celeba128")
    assert reader.read(plain) is None
    assert reader.read(dict(ctx({}), kind="closed_loop_extract")) is None
    listed = next(m for m in spec.load()["per_layer"] if m["name"] == metric)
    assert listed["workloads"] == [CELL]


def test_the_vgg_replay_refuses_a_program_that_computes_another_loss():
    c = conf()
    cfg = spec.program_config(c)
    train_replay_vgg.check(c["perceptual"], cfg)
    for change in ({"train.perceptual_layers": ("relu1_2", "relu2_2")},
                   {"train.loss": "l2"}):
        with pytest.raises(SystemExit):
            train_replay_vgg.check(c["perceptual"], cfg.override(**change))
    other = dict(c["perceptual"], taps=c["perceptual"]["taps"][:-1])
    with pytest.raises(SystemExit):
        train_replay_vgg.check(other, cfg)


def test_the_trunk_draw_is_he_normal_from_the_seed():
    c = conf()["perceptual"]
    a = train_replay_vgg.draw_trunk(c, 2 ** 31 + 5, "cpu")
    b = train_replay_vgg.draw_trunk(c, 2 ** 31 + 5, "cpu")
    assert [k for k, _ in perceptual.param_shapes(c["taps"])] == list(a)
    for k, v in a.items():
        assert torch.equal(v, b[k])
        if v.ndim == 4:
            fan_in = v[0].numel()
            assert v.std().item() == pytest.approx((2 / fan_in) ** 0.5,
                                                   rel=0.1)
        else:
            assert not v.any()
