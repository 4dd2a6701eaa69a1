"""The port's Transporter slice against the JAX package's (CPU).

The plain fused bottleneck against the Pallas ``softargmax_raster_fused`` in
interpret mode (forward and VJP, both variants); the ``amax`` heat mask's
gradient on tied maps against ``jnp.max``'s; the Transporter's forward and
parameter gradients (the stop-gradient recipe) and 3 temporal-mode train
steps at narrow widths, both variants; the parameter tree; serving a
Transporter; scripted Pong and moving dots on JAX's draws. Same
numpy-seeded params (``keypoints_tpu_torch.testing``) and inputs into both
packages; on the CPU the port runs its kernels' plain versions. Every JAX
run is made once, in the module fixture ``jax_ref``.

``python tests/test_torch_transporter.py`` rewrites the committed JAX
reference ``tests/data/torch_port_transporter_atari_train.json``: 3
full-width f32 train steps of transporter_atari at b2, marginal (the
preset) and joint, on seeded temporal pairs (``chip_smoke.py`` holds the GPU
to it, on the card and on that machine's CPU, where JAX is not installed).
A test below regenerates it and fails when it goes stale.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keypoints_tpu.configs import get_config as jax_get_config
from keypoints_tpu.data import synthetic as jax_synthetic
from keypoints_tpu.kernels.fused_bottleneck import softargmax_raster_fused
from keypoints_tpu.training import TrainState as JaxTrainState
from keypoints_tpu.training import build_model as jax_build_model
from keypoints_tpu.training import make_extract_fn as jax_make_extract_fn
from keypoints_tpu.training import make_optimizer as jax_make_optimizer
from keypoints_tpu.training import make_train_step as jax_make_train_step
from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data import synthetic
from keypoints_tpu_torch.models import Transporter
from keypoints_tpu_torch.ops.fused_bottleneck import softargmax_raster
from keypoints_tpu_torch.ops.gaussian import gaussian_maps
from keypoints_tpu_torch.serve import make_live_extract
from keypoints_tpu_torch.testing import (NOISE_GRADIENT, random_flax_params,
                                         random_images)
from keypoints_tpu_torch.training import (build_model, init_state,
                                          make_schedule, make_train_step)

REFERENCE = (Path(__file__).parent / "data"
             / "torch_port_transporter_atari_train.json")
PRESET = "transporter_atari"
VARIANTS = ("marginal", "joint")
# test_torch_train.py's narrow widths on the preset's 1-channel frames, 32²
NARROW = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
          "model.decoder_filters": (16, 8),
          "model.decoder_upsample": (True, True), "model.groups": 4,
          "data.image_size": 32, "train.compute_dtype": "float32",
          "train.batch_size": 3, "train.warmup_steps": 1}
FULL = {"train.compute_dtype": "float32"}


def _cfgs(overrides: dict):
    return (jax_get_config(PRESET).override(**overrides),
            get_config(PRESET).override(**overrides))


def _narrow(variant: str):
    return _cfgs({**NARROW, "model.softmax_variant": variant})


def _as_port(tree) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, tree)).items()}


def _jax_state(jcfg, params):
    tx = jax_make_optimizer(jcfg)
    return JaxTrainState(jnp.zeros((), jnp.int32), params, tx.init(params))


def _jax_steps(jcfg, params, batch, n: int, record_params: bool):
    """n JAX train steps from ``params`` on the same (src, tgt) pair."""
    state = _jax_state(jcfg, params)
    step = jax.jit(jax_make_train_step(jcfg, jax_build_model(jcfg)))
    out = []
    for _ in range(n):
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    _as_port(state.params) if record_params else None))
    return out


def _jax_forward_and_grads(jcfg, params, src, tgt):
    """Reconstruction, target keypoints and the L2 loss's gradients."""
    model = jax_build_model(jcfg)

    def loss(p):
        recon, kp = model.apply({"params": p}, jnp.asarray(src),
                                jnp.asarray(tgt))
        return jnp.mean((recon - jnp.asarray(tgt)) ** 2), (recon, kp)

    (_, (recon, kp)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(recon), np.asarray(kp), _as_port(grads)


def jax_train_reference() -> dict:
    """JAX f32 full-width transporter_atari: for each variant, step-1
    keypoints and per-parameter gradient norms, then 3 temporal-mode train
    steps at b2 on the pair (``random_images(2, cfg, 1)``,
    ``random_images(2, cfg, 2)``) from ``random_flax_params(cfg, 0)``."""
    ref = {"preset": PRESET, "overrides": FULL, "param_seed": 0,
           "image_seeds": [1, 2], "batch": 2, "steps": 3, "runs": {}}
    for variant in VARIANTS:
        jcfg, cfg = _cfgs({**FULL, "model.softmax_variant": variant})
        params = random_flax_params(cfg, ref["param_seed"])
        src, tgt = (random_images(ref["batch"], cfg, s)
                    for s in ref["image_seeds"])
        _, kp, grads = _jax_forward_and_grads(jcfg, params, src, tgt)
        steps = _jax_steps(jcfg, params, (jnp.asarray(src), jnp.asarray(tgt)),
                           ref["steps"], record_params=False)
        ref["runs"][variant] = {
            "keypoints": kp.tolist(),
            "grad_norms": {k: float(np.linalg.norm(v))
                           for k, v in grads.items()},
            "loss": [s[0] for s in steps],
            "grad_norm": [s[1] for s in steps]}
    return ref


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX run of this file: the narrow forward, gradients and 3
    train steps per variant, the narrow parameter tree, and the full-width
    committed reference recomputed."""
    out = {"narrow": {}}
    for variant in VARIANTS:
        jcfg, cfg = _narrow(variant)
        params = random_flax_params(cfg, 0)
        src, tgt = random_images(3, cfg, 1), random_images(3, cfg, 2)
        out["narrow"][variant] = {
            "params": params, "src": src, "tgt": tgt,
            "forward": _jax_forward_and_grads(jcfg, params, src, tgt),
            "steps": _jax_steps(jcfg, params, (jnp.asarray(src),
                                               jnp.asarray(tgt)), 3,
                                record_params=True)}
    jcfg, _ = _narrow("marginal")
    x = jnp.zeros((1, 1, 32, 32))
    out["init_shapes"] = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda: jax_build_model(jcfg).init(
            jax.random.PRNGKey(0), x, x))["params"])
    out["reference"] = jax_train_reference()
    return out


# --- the fused bottleneck (K3's plain version) -------------------------------

def _rand(*shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant,hw", [
    ("joint", ((16, 16), (12, 16))),
    ("marginal", ((16, 24), (12, 16))),
    # the output sizes the CUDA kernel's map writing branches on: Wo % 4 != 0
    # with Ho * Wo odd (scalar stores), Wo < 4, Wo % 4 == 0 at 16x16 (float4
    # runs, transporter_atari's), and a ragged heatmap
    ("joint", ((16, 16), (7, 13))),
    ("marginal", ((13, 29), (5, 3))),
    ("marginal", ((16, 16), (16, 16))),
    ("joint", ((13, 29), (9, 11)))])
def test_plain_bottleneck_matches_the_fused_pallas_kernel(variant, hw, align):
    """Forward 1e-5 (tests/test_kernels.py's bar): 16x16 and 16x24 heatmaps
    rendered at 12x16, then at 7x13, 5x3, 16x16 and 9x11."""
    (h, w), (ho, wo) = hw
    hm = _rand(2, 3, h, w, seed=21, scale=4)
    kp_j, maps_j = softargmax_raster_fused(jnp.asarray(hm), ho, wo, 0.7,
                                           0.15, align, variant=variant,
                                           interpret=True)
    kp, maps = softargmax_raster(torch.from_numpy(hm), ho, wo, 0.7, 0.15,
                                 align, variant)
    assert kp.shape == (2, 3, 2) and maps.shape == (2, 3, ho, wo)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kp_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(maps.numpy(), np.asarray(maps_j), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_bottleneck_vjp_matches_the_fused_pallas_kernel(variant, align):
    """dL/dheatmaps of a loss on both outputs within 1e-4
    (tests/test_kernels.py's bar)."""
    hm = _rand(1, 2, 12, 16, seed=22, scale=3)
    tgt_maps = _rand(1, 2, 12, 16, seed=23)
    tgt_kp = _rand(1, 2, 2, seed=24)

    def f_jax(x):
        kp, maps = softargmax_raster_fused(x, 12, 16, 1.1, 0.2, align,
                                           variant=variant, interpret=True)
        return (jnp.sum((maps - tgt_maps) ** 2)
                + jnp.sum((kp - tgt_kp) ** 2))

    want = jax.grad(f_jax)(jnp.asarray(hm))
    x = torch.from_numpy(hm).requires_grad_(True)
    kp, maps = softargmax_raster(x, 12, 16, 1.1, 0.2, align, variant)
    (((maps - torch.from_numpy(tgt_maps)) ** 2).sum()
     + ((kp - torch.from_numpy(tgt_kp)) ** 2).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_amax_splits_the_gradient_among_ties_as_jnp_max():
    """The heat mask's reduction over K on tied maps: coincident keypoints
    (equal maps) and far corners where every map underflows to 0. Equal to
    ``jax.grad`` of ``jnp.max`` to the bit."""
    kp = np.array([[[0.3, -0.2], [0.3, -0.2], [-0.5, 0.6]]], np.float32)
    g = gaussian_maps(torch.from_numpy(kp), 16, 16, 0.05).numpy()
    # XLA's CPU flushes denormals to zero, so a denormal tail would tie
    # there and not here: zero it on both sides
    g[np.abs(g) < np.finfo(np.float32).tiny] = 0.0
    assert (g[0, 0] == g[0, 1]).all() and (g.max(axis=1) == 0).any()
    cot = _rand(1, 16, 16, seed=25)
    want = jax.grad(lambda x: jnp.sum(x.max(axis=1) * cot))(jnp.asarray(g))
    x = torch.from_numpy(g).requires_grad_(True)
    (x.amax(dim=1) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad[0, 0].abs().sum() > 0          # a tie shares, not takes


# --- the model ---------------------------------------------------------------

def _port_model(cfg, params):
    model = build_model(cfg, "cpu")
    load_model_state(model, state_dict_from_flax(params))
    return model


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_and_param_grads_match_jax(jax_ref, variant):
    """Reconstruction within 5e-5, keypoints within 1e-4, parameter
    gradients of the L2 loss within 2e-5 (docs/PARITY.md's bars). The
    source branch runs without a graph, so the gradients pin JAX's
    stop-gradient on the source features and heat mask."""
    _, cfg = _narrow(variant)
    run = jax_ref["narrow"][variant]
    recon_j, kp_j, grads_j = run["forward"]
    model = _port_model(cfg, run["params"])
    tgt = torch.from_numpy(run["tgt"])
    recon, kp = model(torch.from_numpy(run["src"]), tgt)
    ((recon - tgt) ** 2).mean().backward()
    assert recon.dtype == torch.float32 and recon.shape == (3, 1, 32, 32)
    np.testing.assert_allclose(recon.detach().numpy(), recon_j, rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(kp.detach().numpy(), kp_j, rtol=0, atol=1e-4)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(grads_j)
    for name, want in grads_j.items():
        np.testing.assert_allclose(got[name], want, rtol=0, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_steps_match_jax_temporal(jax_ref, variant):
    """3 temporal-mode steps from the same params and pair: loss and
    grad_norm within 1e-5 relative, parameters within 1e-5
    (``NOISE_GRADIENT`` within the learning rates' sum)."""
    _, cfg = _narrow(variant)
    run = jax_ref["narrow"][variant]
    state = init_state(cfg, "cpu")
    load_model_state(state.model, state_dict_from_flax(run["params"]))
    step = make_train_step(cfg)
    pair = (torch.from_numpy(run["src"]), torch.from_numpy(run["tgt"]))
    lr_sum = sum(make_schedule(cfg)(i) for i in range(3))
    for i, (loss_j, norm_j, params_j) in enumerate(run["steps"]):
        state, metrics = step(state, pair)
        assert metrics["loss"].item() == pytest.approx(loss_j, rel=1e-5)
        assert metrics["grad_norm"].item() == pytest.approx(norm_j, rel=1e-5)
        for name, p in state.model.state_dict().items():
            tol = 2 * lr_sum if name in NOISE_GRADIENT else 1e-5
            np.testing.assert_allclose(p.numpy(), params_j[name], rtol=0,
                                       atol=tol, err_msg=f"step {i + 1} {name}")
    assert state.step == 3


def test_random_flax_params_has_the_tree_of_jax_init(jax_ref):
    _, cfg = _narrow("marginal")
    got = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                 random_flax_params(cfg, 0))
    assert got == jax_ref["init_shapes"]
    # the decoder starts at Φ's width: no keypoint channels
    assert got["decoder"]["Conv_0"]["kernel"] == (3, 3, 16, 16)


@pytest.mark.parametrize("preset,digest", [("celeba128", "52ebe068937388a8"),
                                           ("pose256", "41829199baf77373")])
def test_autoencoder_params_are_unchanged_by_the_transporter_tree(preset,
                                                                  digest):
    """The autoencoder's draws, on which the committed celeba128 and
    pose256 references rest, are the arrays ``random_flax_params`` drew
    before it learnt the Transporter's tree: a digest of every leaf's bytes
    in tree order."""
    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(
            random_flax_params(get_config(preset), 0)):
        h.update(np.ascontiguousarray(leaf).tobytes())
    assert h.hexdigest()[:16] == digest


def test_build_model_builds_the_transporter():
    cfg = get_config(PRESET)
    model = build_model(cfg, "cpu")
    assert isinstance(model, Transporter)
    assert model.softmax_variant == "marginal"
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.encoder.Conv_0.weight.shape == (32, 1, 3, 3)
    assert model.decoder.Conv_0.weight.shape[1] == 128
    with pytest.raises(ValueError, match="model_kind"):
        build_model(cfg.override(**{"train.model_kind": "vae"}), "cpu")


def test_served_transporter_answers_as_jax_extract(jax_ref):
    """A narrow Transporter behind ``make_live_extract`` (buckets 1 and 4,
    1-channel frames): its keypoints are JAX's ``extract_keypoints``, within
    docs/PARITY.md's 1e-3 (measured far below)."""
    jcfg, cfg = _narrow("marginal")
    params = jax_ref["narrow"]["marginal"]["params"]
    live = make_live_extract(cfg, state_dict_from_flax(params), [1, 4], "cpu")
    assert live.meta["channels"] == 1 and live.meta["num_keypoints"] == 4
    jax_extract = jax.jit(jax_make_extract_fn(jcfg, jax_build_model(jcfg)))
    for n in (1, 3, 6):
        images = random_images(n, cfg, 7 + n)
        got = live(images)
        want = np.asarray(jax_extract(params, jnp.asarray(images)))
        assert got.shape == (n, 4, 2)
        assert np.linalg.norm(got - want) <= 1e-3


# --- the committed full-width reference --------------------------------------

def test_committed_train_reference_is_current(jax_ref):
    fresh = jax_ref["reference"]
    committed = json.loads(REFERENCE.read_text())
    assert {k: v for k, v in committed.items() if k != "runs"} == \
        {k: v for k, v in fresh.items() if k != "runs"}
    assert committed["runs"].keys() == fresh["runs"].keys()
    for variant, run in committed["runs"].items():
        new = fresh["runs"][variant]
        for key in ("loss", "grad_norm", "keypoints"):
            np.testing.assert_allclose(np.asarray(new[key]),
                                       np.asarray(run[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{variant} {key}")
        assert new["grad_norms"].keys() == run["grad_norms"].keys()
        for name, value in run["grad_norms"].items():
            assert new["grad_norms"][name] == pytest.approx(value, rel=1e-5)


# --- synthetic temporal pairs ------------------------------------------------

def _jax_pong_draws(key, batch):
    """What ``scripted_pong_pair`` draws from ``key``, as ``PongDraws``."""
    k_pos, k_speed, k_sign, k_pad = jax.random.split(key, 4)
    t = [jax.random.uniform(k_pos, (batch, 2), minval=-0.7, maxval=0.7),
         jax.random.uniform(k_speed, (batch, 2), minval=0.5, maxval=1.5),
         jnp.sign(jax.random.uniform(k_sign, (batch, 2)) - 0.5),
         0.1 * jax.random.normal(k_pad, (batch, 2, 2))]
    return synthetic.PongDraws(*(torch.from_numpy(np.array(a)) for a in t))


def _jax_dots_draws(key, batch, num_dots, max_shift):
    k_pos, k_shift = jax.random.split(key)
    t = [jax.random.uniform(k_pos, (batch, num_dots, 2), minval=-0.7,
                            maxval=0.7),
         jax.random.uniform(k_shift, (batch, num_dots, 2),
                            minval=-max_shift, maxval=max_shift)]
    return synthetic.DotsDraws(*(torch.from_numpy(np.array(a)) for a in t))


@pytest.mark.parametrize("size,dt", [(64, 0.15), (32, 0.9)])
def test_scripted_pong_on_jax_draws_matches_jax(size, dt):
    """Frames within 1e-6 and the state exactly; dt 0.9 sends balls
    through the walls."""
    key = jax.random.PRNGKey(size)
    want = jax_synthetic.scripted_pong_pair(key, 16, size, dt)
    got = synthetic.pong_from_draws(_jax_pong_draws(key, 16), size, dt)
    assert got[0].shape == (16, 1, size, size)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_moving_dots_on_jax_draws_match_jax():
    key = jax.random.PRNGKey(3)
    want = jax_synthetic.moving_dots_pair(key, 8, 32, 5, 3, 0.3)
    got = synthetic.dots_from_draws(_jax_dots_draws(key, 8, 5, 0.3), 32, 3)
    assert got[0].shape == (8, 3, 32, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_reflect_unit_folds_into_the_walls():
    x = torch.tensor([0.3, 1.1, -1.3, 2.5, -5.0])
    np.testing.assert_allclose(synthetic.reflect_unit(x).numpy(),
                               [0.3, 0.9, -0.7, -0.5, -1.0], atol=1e-6)
    assert synthetic.reflect_unit(1.1) == pytest.approx(0.9)


def test_own_draws_lie_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    pong = synthetic.draw_pong(gen, 4096)
    assert pong.ball.abs().max() <= 0.7 and pong.ball.abs().max() > 0.69
    assert pong.speed.min() >= 0.5 and pong.speed.max() <= 1.5
    assert set(pong.sign.unique().tolist()) <= {-1.0, 0.0, 1.0}
    assert abs(pong.sign.mean().item()) < 0.05
    assert abs(pong.noise.std().item() - 0.1) < 0.005
    f1, f2, state = synthetic.pong_from_draws(pong, 32)
    assert f1.shape == f2.shape == (4096, 1, 32, 32)
    assert f1.min() >= 0 and f1.max() <= 1
    assert state.shape == (4096, 3, 2) and state.abs().max() <= 1.0
    dots = synthetic.draw_dots(gen, 4096, 4, 0.2)
    assert dots.positions.abs().max() <= 0.7
    assert dots.shift.abs().max() <= 0.2 and dots.shift.abs().max() > 0.19
    src, tgt, pos = synthetic.moving_dots_pair(gen, 2, 16)
    assert src.shape == tgt.shape == (2, 3, 16, 16) and pos.shape == (2, 4, 2)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    REFERENCE.parent.mkdir(exist_ok=True)
    REFERENCE.write_text(json.dumps(jax_train_reference()) + "\n")
    print(f"wrote {REFERENCE} ({REFERENCE.stat().st_size} bytes)")
