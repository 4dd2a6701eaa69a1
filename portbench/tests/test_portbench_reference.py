"""The plain reference against the program on the CPU in float32, on the
same weights and inputs: the model's outputs and gradients, the training
pair on the same draws, and the decoder's upsampling conv against the
literal layer. A reference that drifted from the program's mathematics
would fail sound runs on the card."""

import json

import pytest
import torch

from portbench import spec, weights
from portbench.reference import augment, model as ref


def conf(name):
    with open(spec.HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def port_model(name, params):
    from keypoints_tpu_torch import training
    cfg = spec.program_config(conf(name)).override(
        **{"train.compute_dtype": "float32"})
    net = training.build_model(cfg, "cpu")
    net.load_state_dict(params, strict=True)
    return net


def test_upsampling_conv_equals_the_literal_layer():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 7, 9), generator=g, dtype=torch.float64)
    w = torch.randn((4, 5, 3, 3), generator=g, dtype=torch.float64)
    b = torch.randn((4,), generator=g, dtype=torch.float64)
    literal = torch.nn.functional.conv2d(
        torch.nn.functional.interpolate(x, scale_factor=2, mode="nearest"),
        w, b, padding=1)
    torch.testing.assert_close(ref.up_conv(x, w, b), literal, rtol=1e-12,
                               atol=1e-12)


def test_model_and_gradients_equal_the_programs_in_float32():
    c = conf("celeba128")
    params = weights.draw(ref.param_shapes(c["model"]), 3, weights.MODEL_SALT,
                          "cpu")
    net = port_model("celeba128", params)
    g = torch.Generator().manual_seed(1)
    src, tgt = (torch.rand((2, 3, 128, 128), generator=g) for _ in range(2))
    recon, kp = net(src, tgt)
    torch.mean((recon - tgt) ** 2).backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    r, k = ref.forward(leaves, c["model"], src, tgt)
    torch.mean((r - tgt) ** 2).backward()
    torch.testing.assert_close(kp, k, rtol=0, atol=1e-6)
    torch.testing.assert_close(recon, r, rtol=0, atol=1e-5)
    # the keypoint head's bias has a gradient of nought up to rounding
    scale = torch.stack([v.grad.norm() for v in leaves.values()]).norm()
    for name, p in net.named_parameters():
        assert (p.grad - leaves[name].grad).norm() <= (
            1e-4 * leaves[name].grad.norm() + 1e-6 * scale), name


@pytest.mark.parametrize("channels", [3, 1])
def test_pair_equals_the_programs_on_the_same_draws(channels):
    from keypoints_tpu_torch import training
    from keypoints_tpu_torch.data import augment as port
    aug = conf("celeba128")["augment"]
    wcfg = training.warp_config(spec.program_config(conf("celeba128")))
    g = torch.Generator().manual_seed(4)
    # smooth images, so the float32 field's rounding is not magnified
    x = torch.nn.functional.interpolate(
        torch.rand((3, channels, 8, 8), generator=g), size=(64, 64),
        mode="bilinear", align_corners=True)
    draws = port.draw_pair(augment.generator(7, 2, "cpu"), tuple(x.shape),
                           wcfg, torch.float32)
    src, tgt = port.pair_from_draws(x, draws, wcfg)
    mine = augment.draw_pair(7, 2, 3, channels, aug, torch.float32, "cpu")
    s, t = augment.make_pair(x, mine, aug)
    torch.testing.assert_close(src, s, rtol=0, atol=1e-4)
    torch.testing.assert_close(tgt, t, rtol=0, atol=1e-4)


def test_rows_are_the_programs_rows():
    from types import SimpleNamespace
    from keypoints_tpu_torch.train import DeviceResidentBatches
    frames = torch.arange(50, dtype=torch.uint8).reshape(50, 1, 1, 1)
    src = DeviceResidentBatches(SimpleNamespace(frames=frames, pairs=None),
                                6, "warp", 12345, 0)
    for step in range(3):
        got = src.sample_at(step).flatten() * 255.0
        want = augment.draw_rows(12345, step, 50, 6, "cpu").float()
        torch.testing.assert_close(got, want)
