"""The port's VGG-16 trunk and perceptual loss against the JAX package's (CPU).

Same weights into both packages: ``random_vgg_params`` (numpy, flax layout)
loaded directly, or written by ``write_torchvision_vgg`` as a torchvision
``vgg16`` file that both packages' loaders read. f32 on both sides; the
tolerances are f32 summation order through up to seven 3×3 convs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keypoints_tpu.losses import make_perceptual_loss as jax_perceptual
from keypoints_tpu.models.vgg import VGG16Features as JaxVGG16Features
from keypoints_tpu.models.vgg import make_feature_fn as jax_feature_fn
from keypoints_tpu_torch.checkpoint import state_dict_from_flax
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.losses import make_perceptual_loss
from keypoints_tpu_torch.models.vgg import (VGGFeatures, load_params,
                                            make_feature_fn,
                                            torchvision_rename_map)
from keypoints_tpu_torch.testing import (random_vgg_params, share_cpu_threads,
                                         write_torchvision_vgg)
from keypoints_tpu_torch.train import make_loss

share_cpu_threads()

TAPS = ("relu1_2", "relu2_2", "relu3_3")


def _images(n, c, size, seed):
    return np.random.RandomState(seed).rand(n, c, size, size).astype(
        np.float32)


@pytest.fixture(scope="module")
def vgg_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg16.pth"
    write_torchvision_vgg(random_vgg_params(0), path)
    return str(path)


@pytest.mark.parametrize("layers", [TAPS, ("relu2_1",)],
                         ids=["pose256-taps", "relu2_1"])
def test_trunk_taps_match_jax(layers):
    """The taps of the same params at 32², within 1e-4 (tests/test_vgg.py's
    bar for the JAX trunk against torch); the trunk stops at the deepest
    tap."""
    params = random_vgg_params(1, layers)
    x = _images(2, 3, 32, seed=2)
    want = JaxVGG16Features(layers=layers).apply(
        {"params": params}, jnp.asarray(x).transpose(0, 2, 3, 1))
    model = VGGFeatures(layers)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_flax(params).items()})
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(layers) == set(want)
    for name in layers:
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]).transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_perceptual_loss_and_its_gradient_match_jax(vgg_file):
    """Both packages read one torchvision-layout file: the loss within 1e-5
    relative and its gradient in the reconstruction within 1e-6."""
    a, b = _images(2, 3, 32, seed=3), _images(2, 3, 32, seed=4)
    jloss = jax_perceptual(jax_feature_fn(TAPS, torch_ckpt=vgg_file), TAPS)
    want, dwant = jax.value_and_grad(jloss)(jnp.asarray(a), jnp.asarray(b))
    loss = make_perceptual_loss(make_feature_fn(TAPS, vgg_file,
                                                device="cpu"), TAPS)
    x = torch.from_numpy(a).requires_grad_(True)
    got = loss(x, torch.from_numpy(b))
    got.backward()
    assert got.dtype == torch.float32 and got.ndim == 0
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dwant), rtol=0,
                               atol=1e-6)
    assert loss(x, x).item() == 0.0


def test_grayscale_input_is_repeated_to_rgb_as_in_jax(vgg_file):
    a, b = _images(2, 1, 32, seed=5), _images(2, 1, 32, seed=6)
    want = float(jax_perceptual(jax_feature_fn(("relu1_2",),
                                               torch_ckpt=vgg_file),
                                ("relu1_2",))(jnp.asarray(a), jnp.asarray(b)))
    feat = make_feature_fn(("relu1_2",), vgg_file, device="cpu")
    got = make_perceptual_loss(feat, ("relu1_2",))(torch.from_numpy(a),
                                                   torch.from_numpy(b))
    assert got.item() == pytest.approx(want, rel=1e-5)
    rgb = torch.from_numpy(np.repeat(a, 3, axis=1))
    torch.testing.assert_close(feat(torch.from_numpy(a))["relu1_2"],
                               feat(rgb)["relu1_2"], rtol=0, atol=0)


def test_strict_load_refuses_missing_keys_and_wrong_shapes(tmp_path):
    params = random_vgg_params(2)
    state = {f"features.{k[len('conv'):]}": torch.from_numpy(v) for k, v in
             state_dict_from_flax(params).items()}
    # a full torchvision file holds deeper convs and the classifier too
    extra = {**state, "features.17.weight": torch.zeros(512, 256, 3, 3),
             "classifier.0.weight": torch.zeros(4, 8)}
    torch.save({"state_dict": extra}, tmp_path / "full.pth")
    model = VGGFeatures()
    load_params(model, str(tmp_path / "full.pth"))
    torch.testing.assert_close(model.conv14.bias,
                               torch.from_numpy(params["conv14"]["bias"]))
    missing = {k: v for k, v in state.items() if k != "features.12.bias"}
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(KeyError, match="conv12.bias"):
        load_params(VGGFeatures(), str(tmp_path / "missing.pth"))
    wrong = {**state, "features.5.weight": torch.zeros(128, 32, 3, 3)}
    torch.save(wrong, tmp_path / "wrong.pth")
    with pytest.raises(ValueError, match="conv5.weight"):
        load_params(VGGFeatures(), str(tmp_path / "wrong.pth"))
    assert torchvision_rename_map()["features.28"] == "conv28"


def test_default_init_is_flax_conv_default_in_distribution():
    """No checkpoint: a fixed init (the same on every call) with zero biases
    and kernels of std 1/sqrt(fan_in) within 5 % (flax's lecun-normal; the
    values differ from JAX's PRNGKey(17) draws)."""
    model = VGGFeatures()
    load_params(model)
    again = VGGFeatures()
    load_params(again)
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, again.state_dict()[name], rtol=0,
                                   atol=0)
        if name.endswith("bias"):
            assert p.abs().max().item() == 0.0, name
        else:
            fan_in = p[0].numel()
            assert p.std().item() == pytest.approx(fan_in ** -0.5, rel=0.05)
            assert p.abs().max().item() <= 2.0 * fan_in ** -0.5 / 0.8796


def test_trunk_is_frozen_and_only_the_input_gets_a_gradient(vgg_file):
    feat = make_feature_fn(TAPS, vgg_file, device="cpu")
    loss = make_perceptual_loss(feat, TAPS)
    target = torch.from_numpy(_images(1, 3, 16, seed=7))
    x = torch.from_numpy(_images(1, 3, 16, seed=8)).requires_grad_(True)
    loss(x, target).backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    with torch.no_grad():
        assert all(not t.requires_grad for t in feat(target).values())
    assert feat(target)["relu1_2"].grad_fn is None


def test_make_loss_wiring(vgg_file, tmp_path):
    """``train.vgg_ckpt`` is read, ``{data_dir}/vgg16.pth`` is the default
    when it exists, else the seeded init; L2 presets get ``None``."""
    base = get_config("pose256").override(**{
        "train.perceptual_layers": ("relu1_2",),
        "train.compute_dtype": "float32"})
    a = torch.from_numpy(_images(1, 3, 32, seed=9))
    b = torch.from_numpy(_images(1, 3, 32, seed=10))
    want = make_perceptual_loss(make_feature_fn(("relu1_2",), vgg_file,
                                                device="cpu"),
                                ("relu1_2",))(a, b).item()
    explicit = make_loss(base.override(**{"train.vgg_ckpt": vgg_file}),
                         "cpu")(a, b).item()
    assert explicit == want
    (tmp_path / "vgg16.pth").write_bytes(open(vgg_file, "rb").read())
    default = make_loss(base.override(**{"data.data_dir": str(tmp_path)}),
                        "cpu")(a, b).item()
    assert default == want
    seeded = make_loss(base.override(**{"data.data_dir": str(tmp_path / "x")}),
                       "cpu")(a, b).item()
    assert abs(seeded - want) > 1e-8
    assert make_loss(get_config("celeba128"), "cpu") is None


def test_make_loss_runs_the_trunk_in_the_compute_dtype(vgg_file):
    """bf16 trunk (pose256's default compute dtype): a float32 loss close to
    the f32 trunk's (rtol 5e-2, tests/test_vgg.py's bar for JAX)."""
    cfg = get_config("pose256").override(**{"train.vgg_ckpt": vgg_file})
    a = torch.from_numpy(_images(2, 3, 32, seed=11))
    b = torch.from_numpy(_images(2, 3, 32, seed=12))
    lb = make_loss(cfg, "cpu")(a, b)
    lf = make_loss(cfg.override(**{"train.compute_dtype": "float32"}),
                   "cpu")(a, b)
    assert lb.dtype == torch.float32
    assert lb.item() == pytest.approx(lf.item(), rel=5e-2)
