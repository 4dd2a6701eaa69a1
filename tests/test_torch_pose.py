"""The port's pose256 training step against the JAX package's (CPU).

pose256 is the 256² / 16-keypoint / VGG-perceptual preset: six encoder
blocks with strides (1, 2, 1, 2, 1, 2), four decoder blocks, σ 0.05, the
perceptual loss on relu1_2, relu2_2 and relu3_3, and augmentation through
the coarse-field warp. Same numpy-seeded model params, images and VGG
weights (``random_vgg_params``, written as one torchvision-layout file that
both packages' loaders read) into both packages, and the port's steps run
on JAX's warps and jitter factors. On the CPU the port runs its kernels'
plain versions.

``PYTHONPATH=. python tests/test_torch_pose.py`` rewrites the committed JAX
reference ``tests/data/torch_port_pose256_train.json``: 3 full-width f32
train steps at b2 on the draws JAX made (``chip_smoke.py`` holds the GPU and
the CPU to it where JAX is not installed). Recomputing it takes minutes on
a CPU, so the test that holds the file current is marked ``slow``.
"""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keypoints_tpu.configs import get_config as jax_get_config
from keypoints_tpu.data.augment import make_pair
from keypoints_tpu.train import make_loss as jax_make_loss
from keypoints_tpu.training import TrainState as JaxTrainState
from keypoints_tpu.training import build_model as jax_build_model
from keypoints_tpu.training import make_optimizer as jax_make_optimizer
from keypoints_tpu.training import make_train_step as jax_make_train_step
from keypoints_tpu.training import warp_config as jax_warp_config
from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data.augment import pair_from_draws, warp_field
from keypoints_tpu_torch.testing import (decode_f32, encode_f32,
                                         grad_norm_tolerance,
                                         random_flax_params, random_images,
                                         random_vgg_params, reference_draws,
                                         reference_warp_draws,
                                         write_torchvision_vgg)
from keypoints_tpu_torch.train import make_loss
from keypoints_tpu_torch.training import (build_model, init_state,
                                          make_train_step, warp_config)
from test_torch_train import _as_port, _flat, record_step_draws

REFERENCE = Path(__file__).parent / "data" / "torch_port_pose256_train.json"
FULL = {"train.compute_dtype": "float32"}
# pose256's structure (strides, upsampling, K=16, σ 0.05, the perceptual
# loss on its three taps) with narrow filters, at 64² (still above the 33²
# field, so the coarse-field warp runs)
REDUCED = {"model.encoder_filters": (8, 8, 16, 16, 16, 16),
           "model.decoder_filters": (16, 16, 8, 8), "model.groups": 4,
           "data.image_size": 64, "train.compute_dtype": "float32"}


def _cfgs(overrides: dict, vgg_path: str = ""):
    overrides = {**overrides, "train.vgg_ckpt": vgg_path}
    return (jax_get_config("pose256").override(**overrides),
            get_config("pose256").override(**overrides))


def _vgg_file(directory, seed: int) -> str:
    path = str(Path(directory) / f"vgg16_seed{seed}.pth")
    write_torchvision_vgg(random_vgg_params(seed), path)
    return path


def jax_train_reference(overrides: dict, vgg_path: str, vgg_seed: int = 0,
                        batch: int = 2, steps: int = 3) -> dict:
    """JAX f32 pose256 with ``overrides``: ``steps`` train steps at
    ``batch`` from ``random_flax_params(cfg, 0)``, the VGG weights of
    ``random_vgg_params(vgg_seed)`` (at ``vgg_path``) and
    ``random_images(batch, cfg, 1)`` (the same batch each step), with the
    warps (as fields, and as the draws they came from) and jitter factors
    each step drew, the step-1 keypoints and per-parameter gradient norms.

    Each step's pair is made by ``make_pair`` on the step's key outside
    the jitted step, which then takes it as a (source, target) batch: made
    inside the jit, XLA's fused f32 arithmetic moves the pair by up to 6e-5
    from the same pair made op by op (measured at 64², step 2), and JAX's
    own gradient norm by 3.4e-4 with it. The op-by-op pair is the one the
    recorded draws give back (the port's is within 1.2e-7 of it).
    """
    ref = {"preset": "pose256", "overrides": overrides, "param_seed": 0,
           "vgg_seed": vgg_seed, "image_seed": 1, "batch": batch,
           "steps": steps, "rng_seed": 2}
    jcfg, cfg = _cfgs(overrides, vgg_path)
    wcfg = jax_warp_config(jcfg)
    params = random_flax_params(cfg, ref["param_seed"])
    images = jnp.asarray(random_images(batch, cfg, ref["image_seed"]))
    b = images.shape[0]
    model = jax_build_model(jcfg)
    loss = jax_make_loss(jcfg)
    tx = jax_make_optimizer(jcfg)
    state = JaxTrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    step = jax.jit(jax_make_train_step(
        jcfg.override(**{"data.pair_mode": "temporal"}), model, loss=loss))
    rng = jax.random.PRNGKey(ref["rng_seed"])
    fields, warp_draws, factors, losses, norms = [], [], [], [], []
    for i in range(steps):
        key = jax.random.fold_in(rng, i)
        record_step_draws(key, b, wcfg, fields, warp_draws, factors)
        src, tgt = make_pair(key, images, wcfg)
        if i == 0:
            def loss_of(p):
                recon, kp = model.apply({"params": p}, src, tgt)
                return loss(recon, tgt), kp

            (_, kp), grads = jax.jit(jax.value_and_grad(
                loss_of, has_aux=True))(params)
            ref["keypoints"] = np.asarray(kp).tolist()
            ref["grad_norms"] = {k: float(np.linalg.norm(v))
                                 for k, v in _as_port(grads).items()}
        state, metrics = step(state, (src, tgt), rng)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    fields = np.asarray(fields, np.float32)
    ref.update(fields_shape=list(fields.shape), fields=encode_f32(fields),
               warp_draws=warp_draws, factors=factors, loss=losses,
               grad_norm=norms)
    return ref


def _port_steps(ref: dict, vgg_path: str):
    """The port on the reference's params, images and draws, on the CPU:
    its step-1 keypoints, losses, grad norms and step-1 per-parameter
    gradient norms."""
    _, cfg = _cfgs(ref["overrides"], vgg_path)
    state = init_state(cfg, "cpu")
    load_model_state(state.model, state_dict_from_flax(
        random_flax_params(cfg, ref["param_seed"])))
    images = torch.from_numpy(random_images(ref["batch"], cfg,
                                            ref["image_seed"]))
    draws = reference_draws(ref)
    src, tgt = pair_from_draws(images, draws[0], warp_config(cfg))
    with torch.no_grad():
        kp = state.model(src, tgt)[1].numpy()
    step = make_train_step(cfg, loss=make_loss(cfg, "cpu"))
    losses, norms, grads = [], [], {}
    for i, d in enumerate(draws):
        state, metrics = step(state, images, d)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        if i == 0:
            grads = {k: p.grad.norm().item()
                     for k, p in state.model.named_parameters()}
    return kp, losses, norms, grads


def _assert_steps_match(ref: dict, got) -> None:
    """Loss and grad_norm within 1e-4 relative at every step, step-1
    keypoints within 1e-4, per-parameter gradient norms of step 1 by
    ``grad_norm_tolerance``: the bars of the celeba128 train parity."""
    kp, losses, norms, grads = got
    np.testing.assert_allclose(kp, ref["keypoints"], rtol=0, atol=1e-4)
    for i in range(ref["steps"]):
        assert losses[i] == pytest.approx(ref["loss"][i], rel=1e-4), i
        assert norms[i] == pytest.approx(ref["grad_norm"][i], rel=1e-4), i
    assert grads.keys() == ref["grad_norms"].keys()
    for name, value in ref["grad_norms"].items():
        assert abs(grads[name] - value) <= grad_norm_tolerance(
            value, ref["grad_norm"][0]), name


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    return _vgg_file(tmp_path_factory.mktemp("vgg"), 0)


# --- the preset's structure -----------------------------------------------------

def test_pose256_structure_at_full_width():
    _, cfg = _cfgs({})
    m = cfg.model
    assert (m.num_keypoints, m.sigma, m.encoder_strides, m.decoder_upsample) \
        == (16, 0.05, (1, 2, 1, 2, 1, 2), (True, True, True, False))
    assert (cfg.train.loss, cfg.train.perceptual_layers) == \
        ("perceptual", ("relu1_2", "relu2_2", "relu3_3"))
    model = build_model(cfg, "cpu")
    assert len(model.encoder.blocks) == len(model.keynet.trunk.blocks) == 6
    assert len(model.decoder.blocks) == 4
    x = torch.from_numpy(random_images(1, cfg.override(
        **{"data.image_size": 64}), 3))
    with torch.no_grad():
        recon, kp = model(x, x)
        hm = model.keynet(x)
    assert recon.shape == (1, 3, 64, 64) and kp.shape == (1, 16, 2)
    assert hm.shape == (1, 16, 8, 8)          # three stride-2 blocks


# --- the reduced slice on JAX's draws ----------------------------------------------

def test_reduced_pose256_steps_match_jax(vgg_path):
    """pose256's structure with narrow filters at 64², f32, b2, over 1 and
    3 steps on JAX's draws and one VGG file."""
    ref = jax_train_reference(REDUCED, vgg_path)
    _assert_steps_match(ref, _port_steps(ref, vgg_path))


# --- the full-width committed reference -------------------------------------------

def test_committed_reference_fields_follow_from_its_warp_draws():
    """The port's TPS turns the committed draws into the committed fields
    (3e-5: JAX's own f32 field error, see test_torch_augment)."""
    ref = json.loads(REFERENCE.read_text())
    assert (ref["preset"], ref["overrides"], ref["batch"], ref["steps"]) == \
        ("pose256", FULL, 2, 3)
    _, cfg = _cfgs(ref["overrides"])
    fields = decode_f32(ref["fields"], ref["fields_shape"])
    assert fields.shape == (3, 2, 2, 33, 33, 2)
    for i, step_draws in enumerate(reference_warp_draws(ref)):
        for j, draws in enumerate(step_draws):
            np.testing.assert_allclose(
                warp_field(draws, warp_config(cfg)).numpy(), fields[i, j],
                rtol=0, atol=3e-5)


@pytest.mark.slow
def test_committed_reference_is_current_and_the_port_matches_it(vgg_path):
    """Recompute the JAX reference at full width (minutes on a CPU), hold
    the committed file to it, and the port's full-width steps to both."""
    fresh = jax_train_reference(FULL, vgg_path)
    committed = json.loads(REFERENCE.read_text())
    numbers = ("fields", "warp_draws", "factors", "loss", "grad_norm",
               "keypoints", "grad_norms")
    assert {k: v for k, v in committed.items() if k not in numbers} == \
        {k: v for k, v in fresh.items() if k not in numbers}
    shape = committed["fields_shape"]
    np.testing.assert_allclose(decode_f32(fresh["fields"], shape),
                               decode_f32(committed["fields"], shape),
                               atol=1e-6)
    for key in ("warp_draws", "factors", "loss", "grad_norm", "keypoints"):
        np.testing.assert_allclose(_flat(fresh[key]), _flat(committed[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for name, value in committed["grad_norms"].items():
        assert fresh["grad_norms"][name] == pytest.approx(value, rel=1e-5)
    _assert_steps_match(committed, _port_steps(committed, vgg_path))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    REFERENCE.parent.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        ref = jax_train_reference(FULL, _vgg_file(tmp, 0))
    REFERENCE.write_text(json.dumps(ref) + "\n")
    print(f"wrote {REFERENCE} ({REFERENCE.stat().st_size} bytes)")
