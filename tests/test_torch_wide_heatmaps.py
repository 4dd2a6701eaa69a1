"""Heatmaps above 64 a side: the port against the JAX package (CPU).

The CUDA soft-argmax kernels take such heatmaps through their
block-per-row path (``csrc/softmax.cuh``); on the CPU the port runs the
plain versions, held here to JAX on the same numpy inputs: the fused
bottleneck against the Pallas ``softargmax_raster_fused`` in interpret mode
(forward and VJP), and a narrow autoencoder whose stride-1 encoders leave
96² heatmaps, forward and parameter gradients against JAX's. The CUDA
kernels are held to these plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py`` phases 23 and 24).
The fused kernel's shared-memory need, computed on the host, is checked
here for both paths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keypoints_tpu.configs import get_config as jax_get_config
from keypoints_tpu.kernels.fused_bottleneck import softargmax_raster_fused
from keypoints_tpu.training import build_model as jax_build_model
from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.kernels import fused_bottleneck_cuda as fbc
from keypoints_tpu_torch.kernels.gaussian_cuda import MAX_TABLE
from keypoints_tpu_torch.losses import l2_loss
from keypoints_tpu_torch.ops.fused_bottleneck import softargmax_raster
from keypoints_tpu_torch.testing import random_flax_params, random_images
from keypoints_tpu_torch.training import build_model

# celeba128 narrowed, with stride-1 encoders on 96² images: 96² heatmaps
WIDE = {"model.encoder_filters": (4, 8), "model.encoder_strides": (1, 1),
        "model.decoder_filters": (8, 4),
        "model.decoder_upsample": (False, False), "model.groups": 4,
        "model.num_keypoints": 3, "data.image_size": 96,
        "train.compute_dtype": "float32"}


def _rand(*shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", ["joint", "marginal"])
def test_plain_bottleneck_matches_the_fused_pallas_kernel_above_64(variant,
                                                                   align):
    """65x96 heatmaps rendered at 33x48: keypoints and maps within 1.5e-5
    (the forward's 1e-5 bar grown with the 96-wide side, as
    ``tests/test_torch_ops.py`` grows it), dL/dheatmaps of a loss on both
    outputs within 1e-4 (``tests/test_kernels.py``'s bar)."""
    hm = _rand(1, 2, 65, 96, seed=31, scale=3)
    tgt_maps = _rand(1, 2, 33, 48, seed=32)
    tgt_kp = _rand(1, 2, 2, seed=33)

    def f_jax(x):
        kp, maps = softargmax_raster_fused(x, 33, 48, 0.7, 0.15, align,
                                           variant=variant, interpret=True)
        loss = (jnp.sum((maps - tgt_maps) ** 2)
                + jnp.sum((kp - tgt_kp) ** 2))
        return loss, (kp, maps)

    (_, (kp_j, maps_j)), grad_j = jax.value_and_grad(f_jax, has_aux=True)(
        jnp.asarray(hm))
    x = torch.from_numpy(hm).requires_grad_(True)
    kp, maps = softargmax_raster(x, 33, 48, 0.7, 0.15, align, variant)
    assert kp.shape == (1, 2, 2) and maps.shape == (1, 2, 33, 48)
    atol = 1e-5 * 96 / 64
    np.testing.assert_allclose(kp.detach().numpy(), np.asarray(kp_j),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(maps.detach().numpy(), np.asarray(maps_j),
                               rtol=0, atol=atol)
    (((maps - torch.from_numpy(tgt_maps)) ** 2).sum()
     + ((kp - torch.from_numpy(tgt_kp)) ** 2).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_autoencoder_with_96_heatmaps_matches_jax(variant):
    """Narrow celeba128 at stride 1 (96² heatmaps) in float32, same params
    and images: keypoints and reconstruction within 1e-5, and the L2 loss's
    parameter gradients within 2e-5 (``tests/test_torch_train.py``'s bar)."""
    over = {**WIDE, "model.softmax_variant": variant}
    jcfg = jax_get_config("celeba128").override(**over)
    cfg = get_config("celeba128").override(**over)
    params = random_flax_params(cfg, 0)
    src = random_images(2, cfg, 1)
    tgt = random_images(2, cfg, 2)
    jmodel = jax_build_model(jcfg)

    def loss(p):
        recon, kp = jmodel.apply({"params": p}, jnp.asarray(src),
                                 jnp.asarray(tgt))
        return jnp.mean((recon - jnp.asarray(tgt)) ** 2), (recon, kp)

    (_, (recon_j, kp_j)), grads_j = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    model = build_model(cfg, "cpu")
    load_model_state(model, state_dict_from_flax(params))
    recon, kp = model(torch.from_numpy(src), torch.from_numpy(tgt))
    assert model.keynet(torch.from_numpy(tgt)).shape == (2, 3, 96, 96)
    assert recon.shape == (2, 3, 96, 96) and kp.shape == (2, 3, 2)
    np.testing.assert_allclose(kp.detach().numpy(), np.asarray(kp_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(recon_j),
                               rtol=0, atol=1e-5)
    l2_loss(recon, torch.from_numpy(tgt)).backward()
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads_j))
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize(("hw", "out", "variant", "want"), [
    ((32, 32), (8, 4100), "marginal", 4108),           # warp path: Ho + Wo
    ((64, 64), (2, MAX_TABLE - 2), "joint", MAX_TABLE),
    ((65, 8), (16, 16), "joint", 32 + fbc.BLOCK_STATIC),
    ((65, 8), (16, 16), "marginal", 32 + fbc.BLOCK_STATIC + 73),
    ((8, 4032), (1, 1), "marginal", 2 + fbc.BLOCK_STATIC + 4040)])
def test_fused_kernel_shared_memory_is_the_table_and_the_block_scratch(
        hw, out, variant, want):
    """``fused_bottleneck_cuda.table_floats``: Ho + Wo up to 64 a side;
    above it the block path's reduction scratch too, and a marginal map's
    H + W sums. The wrapper takes up to ``gaussian_cuda.MAX_TABLE`` (227
    KB), the raster kernel's own limit."""
    assert fbc.table_floats(*hw, *out, variant) == want

