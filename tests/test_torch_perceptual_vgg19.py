"""The port's VGG-19 perceptual loss against the benchmark's plain reference
(``portbench/reference/perceptual.py``) on the CPU, in float32.

Seeded random trunks (the benchmark's He-normal draw) at 32x32, where
VGG-19's four pools still leave 2x2 at relu5_2; the autoencoder at cut
widths. Also: the torchvision ``vgg19`` rename and strict load, the
``{data_dir}/vgg19.pth`` default, the tap names, and VGG-16's bare taps
bit for bit against the loss as the port computed it before VGG-19 (that
computation written out below). No JAX: the JAX package has no VGG-19.
"""

import copy
import math

import pytest
import torch
import torch.nn.functional as F

from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data import augment as port_augment
from keypoints_tpu_torch.losses import make_perceptual_loss
from keypoints_tpu_torch.models.vgg import (VGGFeatures, load_params,
                                            make_feature_fn, split_taps,
                                            torchvision_rename_map,
                                            trunk_layout)
from keypoints_tpu_torch.ops.pool import max_pool_2x2
from keypoints_tpu_torch import training
from keypoints_tpu_torch.train import make_loss
from keypoints_tpu_torch.training import (build_model, make_optimizer,
                                          make_train_step, warp_config,
                                          TrainState)
from portbench import spec as bench_spec
from portbench import weights
from portbench.reference import augment, perceptual
from portbench.reference import model as model_ref

CONF = bench_spec.read_json("configs", "celeba128_vgg19")
TAPS = CONF["perceptual"]["taps"]
PROGRAM_TAPS = tuple(CONF["overrides"]["train.perceptual_layers"])
SIZE = 32
STEP_SIZE = 64


def trunk(seed=0):
    """The benchmark's draw of the trunk: He-normal kernels, zero biases."""
    p = weights.draw(perceptual.param_shapes(TAPS), seed, 23, "cpu")
    return {k: v * math.sqrt(2.0) if v.ndim == 4 else v for k, v in p.items()}


def images(n, seed, size=SIZE):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 3, size, size), generator=g)


@pytest.fixture(scope="module")
def vgg19_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg19") / "vgg19.pth"
    torch.save(trunk(), path)
    return str(path)


def test_the_configurations_taps_name_vgg19_and_every_tap():
    assert PROGRAM_TAPS == tuple(f"vgg19/{t}" for t in TAPS)
    assert split_taps(PROGRAM_TAPS)[0] == "vgg19"
    assert split_taps(("relu1_2", "relu3_3"))[0] == "vgg16"
    # the layout up to relu5_2: 14 convs and 4 pools, torchvision's indices
    layout = trunk_layout(PROGRAM_TAPS)
    assert [i for i, _, _ in layout if i >= 0] == [
        0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30]
    assert sum(i < 0 for i, _, _ in layout) == 4
    assert [(i, c) for i, c, _ in layout] == [
        (i if c else -1, c) for i, c, _ in perceptual.plan(TAPS)]


@pytest.mark.parametrize("taps,match", [
    (("vgg19/relu1_2", "relu2_2"), "one trunk"),
    (("vgg11/relu1_2",), "one trunk"),
    (("vgg19/relu3_5",), "relu3_5"),
    (("relu3_4",), "relu3_4"),          # VGG-16 has no relu3_4
])
def test_taps_of_two_trunks_or_of_none_are_refused(taps, match):
    with pytest.raises(ValueError, match=match):
        VGGFeatures(taps)


def test_the_six_taps_equal_the_reference():
    """float32 on both sides: the same convs (``F.conv2d``), ReLUs and
    first-maximum pools in the same order, so the taps agree to a few ulps
    of float32 (1e-5 of the largest value: the CPU's conv may block its
    sums differently for the two call sites)."""
    p = trunk(1)
    feat = make_feature_fn(PROGRAM_TAPS, None, device="cpu")
    model = VGGFeatures(PROGRAM_TAPS)
    model.load_state_dict({k.replace("features.", "conv"): v
                           for k, v in p.items()}, strict=True)
    x = images(2, 2)
    mean = torch.tensor(perceptual.MEAN).view(1, 3, 1, 1)
    std = torch.tensor(perceptual.STD).view(1, 3, 1, 1)
    with torch.no_grad():
        got = model((x - mean) / std)
        want = perceptual.features(p, TAPS, x)
    assert list(got) == list(PROGRAM_TAPS)
    assert feat(x)["vgg19/relu5_2"].shape == (2, 512, 2, 2)
    for tap in TAPS:
        g, w = got[f"vgg19/{tap}"], want[tap]
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * w.abs().max().item())
    assert want["relu5_2"].abs().max() > 0.1 * want["input"].abs().max()


def test_the_loss_and_its_gradient_equal_the_reference(vgg19_file):
    """The loss within 1e-5 relative and its gradient in the reconstruction
    within 1e-5 of its largest value (float32 sums over the six taps)."""
    a, b = images(2, 3), images(2, 4)
    loss = make_perceptual_loss(make_feature_fn(PROGRAM_TAPS, vgg19_file,
                                                device="cpu"), PROGRAM_TAPS)
    x = a.clone().requires_grad_(True)
    got = loss(x, b)
    got.backward()
    r = a.clone().requires_grad_(True)
    want = perceptual.perceptual_loss(trunk(), TAPS, r, b)
    want.backward()
    assert got.dtype == torch.float32 and got.ndim == 0
    assert got.item() == pytest.approx(want.item(), rel=1e-5)
    torch.testing.assert_close(x.grad, r.grad, rtol=0,
                               atol=1e-5 * r.grad.abs().max().item())
    assert loss(x, x).item() == 0.0


def small_conf():
    """The configuration at cut widths and 64x64, for the CPU (at 32x32 the
    program warps through the dense TPS grid, which the reference, written
    for images wider than the 33x33 field, does not)."""
    c = copy.deepcopy(CONF)
    c["model"].update(image_size=STEP_SIZE, encoder_filters=[8, 16],
                      encoder_strides=[1, 2], decoder_filters=[16, 8],
                      decoder_upsample=[False, True], groups=4)
    c["compute_dtype"] = "float32"
    c["train_batch"] = 4
    c["overrides"].update({
        "model.encoder_filters": [8, 16], "model.encoder_strides": [1, 2],
        "model.decoder_filters": [16, 8],
        "model.decoder_upsample": [False, True], "model.groups": 4,
        "data.image_size": STEP_SIZE, "train.compute_dtype": "float32",
        "train.batch_size": 4})
    return c


def smooth(n, seed, size=STEP_SIZE):
    """Frames without pixel noise: the max pools' routing of the gradient
    flips under noise of 1e-7 on i.i.d. noise images (a 1e-3 change in
    the loss's gradient, float64 alike), not on smooth ones."""
    g = torch.Generator().manual_seed(seed)
    return F.interpolate(torch.rand((n, 3, 8, 8), generator=g),
                         size=(size, size), mode="bilinear",
                         align_corners=True)


def test_one_train_step_equals_the_references_step(vgg19_file, monkeypatch):
    """The program's eager step (forward, perceptual loss, backward, Adam)
    against the reference's on the same weights, frames and draws: the loss
    within 1e-5 relative, each leaf's gradient within 2e-5 of its norm plus
    1e-5 of the median leaf's (float32 sums in other orders through 8 + 14
    convs; Psi's head bias has a gradient of nought up to rounding), the
    parameters after the step to 1e-7 (the warm-up's first rate is 0). The
    step is given the reference's pair: each side's float32 TPS field
    moves the pair by ~1.2e-5 a pixel, which moves Phi's first conv's
    gradient by 1e-3 of its norm (the pair is held to the program's in
    ``portbench/tests/test_portbench_reference.py``)."""
    c = small_conf()
    cfg = bench_spec.program_config(c, 5).override(
        **{"train.vgg_ckpt": vgg19_file})
    params = weights.draw(model_ref.param_shapes(c["model"]), 5,
                          weights.MODEL_SALT, "cpu")
    net = build_model(cfg, "cpu")
    net.load_state_dict(params, strict=True)
    state = TrainState(net, make_optimizer(cfg, net.parameters()))
    frames = smooth(4, 6)
    mine = augment.draw_pair(5, 0, 4, 3, c["augment"], torch.float32, "cpu")
    monkeypatch.setattr(training, "pair_from_draws", lambda *a, **k:
                        augment.make_pair(frames, mine, c["augment"]))
    draws = port_augment.draw_pair(augment.generator(5, 0, "cpu"),
                                   tuple(frames.shape), warp_config(cfg),
                                   torch.float32)
    step = make_train_step(cfg, loss=make_loss(cfg, "cpu"))
    _, metrics = step(state, frames, draws=draws)
    want = perceptual.run_steps(params, trunk(), c, [frames], [mine], 2)
    assert metrics["loss"].item() == pytest.approx(want["losses"][0],
                                                   rel=1e-5)
    ref_grads = want["grads"][0]
    median = torch.stack([v.norm() for v in ref_grads.values()]).median()
    for name, p in net.named_parameters():
        w = ref_grads[name]
        assert (p.grad - w).norm() <= 2e-5 * w.norm() + 1e-5 * median, name
        torch.testing.assert_close(p.detach(), want["params"][name],
                                   rtol=0, atol=1e-7)


def test_loss_and_every_gradient_on_one_pair_equal_the_reference(
        vgg19_file):
    """The model, the loss and the backward on one (source, target) pair
    of other weights and frames: the loss within 1e-6 relative, each
    leaf's gradient within 2e-5 of its norm plus 1e-5 of the median leaf's
    (float32 sums in other orders through 8 + 14 convs; Psi's head bias is
    rounding noise)."""
    c = small_conf()
    cfg = bench_spec.program_config(c, 5).override(
        **{"train.vgg_ckpt": vgg19_file})
    params = weights.draw(model_ref.param_shapes(c["model"]), 7,
                          weights.MODEL_SALT, "cpu")
    net = build_model(cfg, "cpu")
    net.load_state_dict(params, strict=True)
    src, tgt = smooth(4, 11), smooth(4, 12)
    recon, _ = net(src, tgt)
    got = make_loss(cfg, "cpu")(recon, tgt)
    got.backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    r, _ = model_ref.forward(leaves, c["model"], src, tgt)
    want = perceptual.perceptual_loss(trunk(), c["perceptual"]["taps"], r,
                                      tgt)
    want.backward()
    assert got.item() == pytest.approx(want.item(), rel=1e-6)
    median = torch.stack([v.grad.norm() for v in leaves.values()]).median()
    for name, p in net.named_parameters():
        w = leaves[name].grad
        assert (p.grad - w).norm() <= 2e-5 * w.norm() + 1e-5 * median, name


def test_the_torchvision_vgg19_file_loads_strictly(tmp_path):
    """A whole torchvision ``vgg19`` file (deeper convs and the classifier
    too) fills the trunk; a missing conv or a VGG-16 file is refused."""
    p = trunk(2)
    full = {**p, "features.32.weight": torch.zeros(512, 512, 3, 3),
            "features.34.bias": torch.zeros(512),
            "classifier.0.weight": torch.zeros(4, 8)}
    torch.save({"state_dict": full}, tmp_path / "full.pth")
    model = VGGFeatures(PROGRAM_TAPS)
    load_params(model, str(tmp_path / "full.pth"))
    torch.testing.assert_close(model.conv30.weight, p["features.30.weight"],
                               rtol=0, atol=0)
    assert torchvision_rename_map("vgg19")["features.25"] == "conv25"
    assert "features.25" not in torchvision_rename_map()
    missing = {k: v for k, v in p.items() if k != "features.23.bias"}
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(KeyError, match="VGG19 trunk parameters.*conv23.bias"):
        load_params(VGGFeatures(PROGRAM_TAPS), str(tmp_path / "missing.pth"))
    # VGG-16's features.19 is 512 -> 512; VGG-19's 256 -> 512
    vgg16 = {**p, "features.19.weight": torch.zeros(512, 512, 3, 3)}
    torch.save(vgg16, tmp_path / "vgg16.pth")
    with pytest.raises(ValueError, match="conv19.weight"):
        load_params(VGGFeatures(PROGRAM_TAPS), str(tmp_path / "vgg16.pth"))


def test_make_loss_takes_the_trunks_own_default_file(vgg19_file, tmp_path):
    """VGG-19 taps read ``{data_dir}/vgg19.pth`` and never ``vgg16.pth``."""
    base = get_config("celeba128").override(**{
        "train.loss": "perceptual", "train.perceptual_layers": PROGRAM_TAPS,
        "train.compute_dtype": "float32"})
    a, b = images(1, 7), images(1, 8)
    want = make_loss(base.override(**{"train.vgg_ckpt": vgg19_file}),
                     "cpu")(a, b).item()
    only16 = tmp_path / "only16"
    only16.mkdir()
    (only16 / "vgg16.pth").write_bytes(open(vgg19_file, "rb").read())
    seeded = make_loss(base.override(**{"data.data_dir": str(only16)}),
                       "cpu")(a, b).item()
    assert seeded != want
    (tmp_path / "vgg19.pth").write_bytes(open(vgg19_file, "rb").read())
    default = make_loss(base.override(**{"data.data_dir": str(tmp_path)}),
                        "cpu")(a, b).item()
    assert default == want


VGG16_TAPS = ("relu1_2", "relu2_2", "relu3_3")
# the VGG-16 trunk's (torchvision index, tap) up to relu3_3; -1 a pool
VGG16_PLAN = [(0, "relu1_1"), (2, "relu1_2"), (-1, "pool1"), (5, "relu2_1"),
              (7, "relu2_2"), (-1, "pool2"), (10, "relu3_1"),
              (12, "relu3_2"), (14, "relu3_3")]


def todays_vgg16_loss(state: dict, dtype, recon, target):
    """The port's perceptual loss on VGG-16's bare taps as it was computed
    before VGG-19 (its trunk, normalisation and sum, written out)."""
    mean = torch.tensor(perceptual.MEAN).reshape(3, 1, 1)
    std = torch.tensor(perceptual.STD).reshape(3, 1, 1)

    def feats(img):
        x = ((img - mean) / std).to(dtype)
        out = {}
        for idx, name in VGG16_PLAN:
            if idx < 0:
                x = max_pool_2x2(x)
            else:
                w, b = state[f"conv{idx}.weight"], state[f"conv{idx}.bias"]
                x = F.relu(F.conv2d(x.to(dtype), w.to(dtype), b.to(dtype),
                                    padding=1))
            if name in VGG16_TAPS:
                out[name] = x.float()
        return out

    fr, ft = feats(recon), feats(target)
    total = 0.0
    for name in VGG16_TAPS:
        total = total + torch.mean((fr[name] - ft[name]) ** 2)
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_vgg16_bare_taps_are_unchanged_bit_for_bit(dtype):
    """pose256's loss: the seeded default trunk, the loss and its gradient
    in the reconstruction equal to the bit."""
    feat = make_feature_fn(VGG16_TAPS, None, dtype, device="cpu")
    model = VGGFeatures(VGG16_TAPS)
    load_params(model)
    state = model.state_dict()
    loss = make_perceptual_loss(feat, VGG16_TAPS)
    a, b = images(2, 9), images(2, 10)
    x, y = a.clone().requires_grad_(True), a.clone().requires_grad_(True)
    got, want = loss(x, b), todays_vgg16_loss(state, dtype, y, b)
    got.backward()
    want.backward()
    assert torch.equal(got, want)
    assert torch.equal(x.grad, y.grad)


def test_the_configuration_file_states_the_cut():
    """Every width as in celeba128's file; only the loss differs."""
    base = bench_spec.read_json("configs", "celeba128")
    assert CONF["model"] == base["model"]
    assert CONF["reduced"] == ["first_kernel", "norm", "upsample"]
    assert CONF["loss"] == {"kind": "perceptual"}
    assert {k: v for k, v in CONF["overrides"].items()
            if k not in ("train.loss", "train.perceptual_layers")} \
        == base["overrides"]
    assert PROGRAM_TAPS == tuple(f"vgg19/{t}" for t in TAPS)
