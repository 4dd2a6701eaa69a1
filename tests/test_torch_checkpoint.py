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


# --- a port-trained step file back into JAX ----------------------------------

def _train_steps(tmp_path, steps: int = 3):
    from keypoints_tpu_torch import train as train_mod
    cfg = configs.get_config("celeba128").override(**{
        **NARROW, "data.dataset": "synthetic_dots", "train.batch_size": 4,
        "train.steps": steps, "train.checkpoint_every": steps,
        "train.log_every": 100, "train.eval_every": 1000,
        "train.checkpoint_dir": str(tmp_path)})
    return cfg, train_mod.train(cfg, device="cpu")


def test_port_step_file_loads_through_jax_converter(tmp_path):
    """A step file of 3 port train steps goes through JAX's unedited
    ``load_torch_checkpoint`` (the ``"state_dict"`` key of format 2), and
    JAX's extract on those params matches the port's keypoints within
    1e-3 (docs/PARITY.md)."""
    import jax.numpy as jnp

    from keypoints_tpu.checkpoint import load_torch_checkpoint
    from keypoints_tpu.training import build_model as jax_build_model
    from keypoints_tpu.training import make_extract_fn as jax_extract_fn
    from keypoints_tpu_torch.testing import random_images
    from keypoints_tpu_torch.training import make_extract_fn

    cfg, state = _train_steps(tmp_path)
    params = load_torch_checkpoint(str(tmp_path / "celeba128" / "3.pt"))
    jcfg = jax_configs.get_config("celeba128").override(**NARROW)
    images = random_images(4, cfg, 5)
    want = jax.jit(jax_extract_fn(jcfg, jax_build_model(jcfg)))(
        params, jnp.asarray(images))
    got = make_extract_fn(state.model)(torch.from_numpy(images)).numpy()
    assert float(np.linalg.norm(got - np.asarray(want), axis=-1).max()) < 1e-3


def test_format_1_step_files_still_restore(tmp_path):
    """A step file of the first layout (the model under ``"model"``)
    restores, and ``load_checkpoint`` reads its model."""
    from keypoints_tpu_torch import checkpoint as ckpt
    from keypoints_tpu_torch.training import init_state

    cfg, state = _train_steps(tmp_path)
    path = tmp_path / "celeba128" / "3.pt"
    payload = torch.load(path, weights_only=True)
    assert payload["format"] == ckpt.FORMAT == 2
    payload["format"], payload["model"] = 1, payload.pop("state_dict")
    torch.save(payload, path)
    restored = ckpt.CheckpointManager(str(path.parent)).restore(
        3, init_state(cfg, "cpu"))
    for key, value in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[key], value), key
        assert torch.equal(load_checkpoint(str(path))[key], value), key
    payload["format"] = 3
    torch.save(payload, path)
    with pytest.raises(ValueError, match="checkpoint format 3"):
        ckpt.CheckpointManager(str(path.parent)).restore(
            3, init_state(cfg, "cpu"))
