"""Weights and configs carried from the JAX package into the port (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from keypoints_tpu import configs as jax_configs
from keypoints_tpu.checkpoint import (export_torch_state_dict,
                                      save_torch_checkpoint)
from keypoints_tpu.training import init_state
from keypoints_tpu_torch import configs
from keypoints_tpu_torch.checkpoint import (load_checkpoint, load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.testing import random_flax_params
from keypoints_tpu_torch.training import build_model, freeze_for_inference

NARROW = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
          "model.decoder_filters": (16, 8),
          "model.decoder_upsample": (True, True), "model.groups": 4,
          "model.num_keypoints": 4, "data.image_size": 32,
          "train.compute_dtype": "float32"}


@pytest.fixture(scope="module")
def flax_params():
    """Real ``init_state`` params (Φ, Ψ and decoder) of a narrow celeba128."""
    cfg = jax_configs.get_config("celeba128").override(**NARROW)
    return jax.tree_util.tree_map(np.asarray,
                                  init_state(cfg, jax.random.PRNGKey(0)).params)


def test_state_dict_from_flax_equals_jax_export(flax_params):
    got = state_dict_from_flax(flax_params)
    want = export_torch_state_dict(flax_params)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_module_names_are_the_flax_paths():
    cfg = configs.get_config("celeba128")
    model = build_model(cfg, "cpu")
    sd = state_dict_from_flax(random_flax_params(cfg, 0))
    assert set(model.state_dict()) == set(sd)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}


def test_jax_export_torch_file_loads_strict(flax_params, tmp_path):
    """The file ``keypoints-convert export-torch`` writes (no --rename)."""
    path = str(tmp_path / "kp.pt")
    save_torch_checkpoint(path, flax_params)
    state = load_checkpoint(path)
    model = build_model(configs.get_config("celeba128").override(**NARROW),
                        "cpu")
    load_model_state(model, state)
    assert {k.split(".")[0] for k in state} == {"encoder", "keynet",
                                                "decoder"}
    assert set(model.state_dict()) == set(state)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, state[key], rtol=0, atol=0)


def test_bf16_model_stores_convs_in_bf16_and_norms_in_f32(flax_params):
    """A bf16 model keeps float32 parameters for training (flax's
    param_dtype); the serving model stores its convs in bf16, cast once at
    load by freeze_for_inference, and its GroupNorms in float32."""
    model = build_model(configs.get_config("celeba128").override(
        **{**NARROW, "train.compute_dtype": "bfloat16"}), "cpu")
    load_model_state(model, state_dict_from_flax(flax_params))
    assert {v.dtype for v in model.state_dict().values()} == {torch.float32}
    dtypes = {k: v.dtype
              for k, v in freeze_for_inference(model).state_dict().items()}
    assert dtypes["keynet.trunk.Conv_0.weight"] == torch.bfloat16
    assert dtypes["keynet.head.weight"] == torch.bfloat16
    assert dtypes["decoder.Conv_0.weight"] == torch.bfloat16
    assert dtypes["keynet.trunk.GroupNorm_0.weight"] == torch.float32
    assert not any(p.requires_grad for p in model.parameters())


def test_unknown_or_missing_keys_raise(flax_params):
    cfg = configs.get_config("celeba128").override(**NARROW)
    state = state_dict_from_flax(flax_params)
    with pytest.raises(KeyError, match="unexpected"):
        load_model_state(build_model(cfg, "cpu"),
                         {**state, "transporter.Conv_0.weight": np.zeros(1)})
    for gone in ("keynet.head.bias", "decoder.Conv_1.weight"):
        missing = {k: v for k, v in state.items() if k != gone}
        with pytest.raises(RuntimeError, match=gone.split(".", 1)[1]):
            load_model_state(build_model(cfg, "cpu"), missing)


def test_bfloat16_leaves_become_float32():
    import ml_dtypes
    params = {"keynet": {"head": {
        "kernel": np.ones((1, 1, 2, 3), ml_dtypes.bfloat16),
        "bias": np.zeros(3, ml_dtypes.bfloat16)}}}
    sd = state_dict_from_flax(params)
    assert sd["keynet.head.weight"].dtype == np.float32
    assert sd["keynet.head.weight"].shape == (3, 2, 1, 1)


@pytest.mark.parametrize("name", sorted(jax_configs.PRESETS))
def test_presets_equal_jax_presets(name):
    assert dataclasses.asdict(configs.PRESETS[name]) == \
        dataclasses.asdict(jax_configs.PRESETS[name])


def test_overrides_parse_like_jax():
    items = ["model.encoder_filters=(8,16)", "train.lr=3e-4",
             "model.softmax_variant=joint", "train.save_best=false"]
    got = configs.apply_overrides(configs.get_config("celeba128"), items)
    want = jax_configs.apply_overrides(jax_configs.get_config("celeba128"),
                                       items)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
