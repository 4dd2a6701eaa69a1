"""The port's extract path against the JAX package, same params and images (CPU).

Params are made in flax layout by ``keypoints_tpu_torch.testing`` and handed
to both packages (converted for the port by ``state_dict_from_flax``), so the
comparison covers the conv stack, GroupNorm, the soft-argmax and the weight
conversion together. On the CPU the port runs its plain soft-argmax.

``python tests/test_torch_models.py`` rewrites the committed JAX reference
``tests/data/torch_port_celeba128_extract.json`` (``chip_smoke.py`` holds
the GPU against it, where JAX is not installed).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keypoints_tpu.configs import get_config as jax_get_config
from keypoints_tpu.training import build_model as jax_build_model
from keypoints_tpu.training import make_extract_fn as jax_make_extract_fn
from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.testing import random_flax_params, random_images
from keypoints_tpu_torch.training import build_model, make_extract_fn

REFERENCE = Path(__file__).parent / "data" / "torch_port_celeba128_extract.json"
# __graft_entry__.py's narrow celeba128, K=4
NARROW = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
          "model.groups": 4, "model.num_keypoints": 4,
          "data.image_size": 32}
F32 = {"train.compute_dtype": "float32"}
BF16 = {"train.compute_dtype": "bfloat16"}


def _jax(overrides: dict, params: dict, images: np.ndarray):
    """JAX keypoints and NCHW heatmaps of celeba128 with ``overrides``."""
    cfg = jax_get_config("celeba128").override(**overrides)
    model = jax_build_model(cfg)
    x = jnp.asarray(images)
    kp = jax.jit(jax_make_extract_fn(cfg, model))(params, x)
    hm = model.apply({"params": params}, x,
                     method=lambda m, x: m.keynet(x.transpose(0, 2, 3, 1)))
    return (np.asarray(kp),
            np.asarray(hm.astype(jnp.float32)).transpose(0, 3, 1, 2))


def _port(overrides: dict, params: dict, images: np.ndarray):
    """The port's keypoints and heatmaps on the CPU, same config and params."""
    model = build_model(get_config("celeba128").override(**overrides), "cpu")
    load_model_state(model, state_dict_from_flax(params))
    x = torch.from_numpy(images)
    with torch.inference_mode():
        hm = model.keynet(x).float().numpy()
    return make_extract_fn(model)(x).numpy(), hm


def _inputs(overrides: dict, n: int):
    cfg = get_config("celeba128").override(**overrides)
    return random_flax_params(cfg, 0), random_images(n, cfg, 1)


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_extract_matches_jax_f32_narrow(variant):
    ov = {**NARROW, **F32, "model.softmax_variant": variant}
    params, images = _inputs(ov, 3)
    kp_jax, hm_jax = _jax(ov, params, images)
    kp, hm = _port(ov, params, images)
    assert kp.shape == (3, 4, 2) and hm.shape == (3, 4, 8, 8)
    np.testing.assert_allclose(hm, hm_jax, rtol=0, atol=1e-4)
    np.testing.assert_allclose(kp, kp_jax, rtol=0, atol=1e-4)


@pytest.mark.parametrize("overrides", [NARROW, {}], ids=["narrow", "full"])
def test_extract_bf16_within_jax_own_bf16_gap(overrides):
    """bf16 rounds at other places in the two frameworks, so no fixed bf16
    bar is honest: the port's bf16 error against JAX-f32 may be at most
    twice JAX-bf16's own error against JAX-f32 (or 1e-3)."""
    params, images = _inputs({**overrides, **BF16}, 2)
    kp_f32, _ = _jax({**overrides, **F32}, params, images)
    kp_jax_bf16, _ = _jax({**overrides, **BF16}, params, images)
    kp_bf16, _ = _port({**overrides, **BF16}, params, images)
    jax_gap = float(np.abs(kp_jax_bf16 - kp_f32).max())
    port_gap = float(np.abs(kp_bf16 - kp_f32).max())
    assert np.isfinite(kp_bf16).all()
    assert port_gap <= max(2 * jax_gap, 1e-3), (port_gap, jax_gap)


def test_extract_matches_jax_full_width_f32():
    params, images = _inputs(F32, 2)
    kp_jax, hm_jax = _jax(F32, params, images)
    kp, hm = _port(F32, params, images)
    assert kp.shape == (2, 10, 2) and hm.shape == (2, 10, 32, 32)
    np.testing.assert_allclose(hm, hm_jax, rtol=0, atol=1e-4)
    np.testing.assert_allclose(kp, kp_jax, rtol=0, atol=1e-4)


def jax_reference() -> dict:
    """The committed reference: JAX f32 keypoints of full-width celeba128."""
    ref = {"preset": "celeba128", "compute_dtype": "float32",
           "param_seed": 0, "image_seed": 1, "n_images": 4}
    cfg = get_config(ref["preset"]).override(**F32)
    params = random_flax_params(cfg, ref["param_seed"])
    images = random_images(ref["n_images"], cfg, ref["image_seed"])
    kp, _ = _jax(F32, params, images)
    return {**ref, "keypoints": kp.tolist()}


def test_committed_jax_reference_is_current():
    """The JAX keypoints the GPU smoke test is held to: regenerated here so
    the file cannot go stale, and the port's CPU output checked against it."""
    committed = json.loads(REFERENCE.read_text())
    fresh = jax_reference()
    assert {k: v for k, v in committed.items() if k != "keypoints"} == \
        {k: v for k, v in fresh.items() if k != "keypoints"}
    want = np.asarray(committed["keypoints"], np.float32)
    np.testing.assert_allclose(np.asarray(fresh["keypoints"], np.float32),
                               want, rtol=0, atol=1e-6)
    cfg = get_config("celeba128").override(**F32)
    kp, _ = _port(F32, random_flax_params(cfg, committed["param_seed"]),
                  random_images(committed["n_images"], cfg,
                                committed["image_seed"]))
    np.testing.assert_allclose(kp, want, rtol=0, atol=1e-4)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    REFERENCE.parent.mkdir(exist_ok=True)
    REFERENCE.write_text(json.dumps(jax_reference()) + "\n")
    print(f"wrote {REFERENCE}")
