"""The port's training slice against the JAX package's (CPU).

Same numpy-seeded params (``keypoints_tpu_torch.testing``) and inputs into
both packages: ``UpsampleConv``, the autoencoder's forward and its parameter
gradients, the learning-rate schedule, ``make_train_step`` over 1 and 3
steps (temporal mode, with gradient accumulation and the diversity term as
cases), and one full-width celeba128 run in warp mode on JAX's draws.
On the CPU the port runs its plain kernels' versions.

``python tests/test_torch_train.py`` rewrites the committed JAX reference
``tests/data/torch_port_celeba128_train.json``: 3 full-width f32 train steps
at b2 with the warps and jitter factors JAX drew (``chip_smoke.py`` holds
the GPU to it, where JAX is not installed). A test below regenerates it and
fails when it goes stale.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from keypoints_tpu.configs import get_config as jax_get_config
from keypoints_tpu.data.augment import make_pair, random_warp_field
from keypoints_tpu.models.nets import UpsampleConv as JaxUpsampleConv
from keypoints_tpu.ops.color import _factor
from keypoints_tpu.training import TrainState as JaxTrainState
from keypoints_tpu.training import build_model as jax_build_model
from keypoints_tpu.training import make_optimizer as jax_make_optimizer
from keypoints_tpu.training import make_train_step as jax_make_train_step
from keypoints_tpu.training import warp_config as jax_warp_config
from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data.augment import pair_from_draws, warp_field
from keypoints_tpu_torch.losses import l2_loss
from keypoints_tpu_torch.models.nets import UpsampleConv
from keypoints_tpu_torch.testing import (NOISE_GRADIENT, decode_f32,
                                         encode_f32, grad_norm_tolerance,
                                         random_flax_params, random_images,
                                         reference_draws,
                                         reference_warp_draws)
from keypoints_tpu_torch.training import (build_model, init_state,
                                          make_schedule, make_train_step,
                                          warp_config)
from test_torch_augment import jax_warp_draws

REFERENCE = Path(__file__).parent / "data" / "torch_port_celeba128_train.json"
# __graft_entry__.py's narrow celeba128 (its decoder too), K=4, 32²
NARROW = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
          "model.decoder_filters": (16, 8),
          "model.decoder_upsample": (True, True), "model.groups": 4,
          "model.num_keypoints": 4, "data.image_size": 32,
          "train.compute_dtype": "float32"}
# warmup 1: the first update's rate is 0 and the next ones are not
TEMPORAL = {**NARROW, "data.pair_mode": "temporal", "train.batch_size": 4,
            "train.warmup_steps": 1}


def _cfgs(overrides: dict):
    return (jax_get_config("celeba128").override(**overrides),
            get_config("celeba128").override(**overrides))


def _port_model(cfg, params):
    model = build_model(cfg, "cpu")
    load_model_state(model, state_dict_from_flax(params))
    return model


def _as_port(tree) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, tree)).items()}


# --- modules ----------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,hw", [(3, 5, (6, 7)), (8, 16, (4, 4))])
def test_upsample_conv_matches_interpolate_conv_and_jax(cin, cout, hw):
    rs = np.random.RandomState(0)
    x = rs.randn(2, cin, *hw).astype(np.float32)
    kernel = (rs.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rs.randn(cout)).astype(np.float32)
    mod = UpsampleConv(cin, cout)
    load_model_state(mod, state_dict_from_flax({"kernel": kernel,
                                                "bias": bias}))
    xt = torch.from_numpy(x)
    got = mod(xt).detach().numpy()
    up = F.conv2d(F.interpolate(xt, scale_factor=2, mode="nearest"),
                  mod.weight, mod.bias, padding=1).detach().numpy()
    want = JaxUpsampleConv(cout).apply(
        {"params": {"kernel": kernel, "bias": bias}},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert got.shape == (2, cout, 2 * hw[0], 2 * hw[1])
    np.testing.assert_allclose(got, up, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_forward_and_param_grads_match_jax(variant):
    """Reconstruction within 5e-5, keypoints within 1e-4, parameter
    gradients of the L2 loss within 2e-5 (docs/PARITY.md's bars)."""
    jcfg, cfg = _cfgs({**NARROW, "model.softmax_variant": variant})
    params = random_flax_params(cfg, 0)
    src = random_images(3, cfg, 1)
    tgt = random_images(3, cfg, 2)
    jmodel = jax_build_model(jcfg)

    def loss(p):
        recon, kp = jmodel.apply({"params": p}, jnp.asarray(src),
                                 jnp.asarray(tgt))
        return jnp.mean((recon - jnp.asarray(tgt)) ** 2), (recon, kp)

    (_, (recon_j, kp_j)), grads_j = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    model = _port_model(cfg, params)
    recon, kp = model(torch.from_numpy(src), torch.from_numpy(tgt))
    l2_loss(recon, torch.from_numpy(tgt)).backward()
    assert recon.dtype == torch.float32 and recon.shape == (3, 3, 32, 32)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(recon_j),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(kp.detach().numpy(), np.asarray(kp_j),
                               rtol=0, atol=1e-4)
    want = _as_port(grads_j)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=2e-5,
                                   err_msg=name)


def test_bf16_compute_keeps_float32_parameters():
    _, cfg = _cfgs({**NARROW, "train.compute_dtype": "bfloat16",
                    "train.batch_size": 2})
    state = init_state(cfg, "cpu")
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    step = make_train_step(cfg)
    images = torch.from_numpy(random_images(2, cfg, 3))
    for _ in range(2):
        state, metrics = step(state, images)
    assert state.step == 2
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in state.model.parameters())
    assert torch.isfinite(metrics["loss"]) and metrics["loss"].ndim == 0


# --- optimizer and train step -------------------------------------------------

@pytest.mark.parametrize("overrides", [{}, {"train.warmup_steps": 0},
                                       {"train.steps": 50,
                                        "train.warmup_steps": 60}],
                         ids=["preset", "no-warmup", "short"])
def test_lr_schedule_matches_optax(overrides):
    jcfg, cfg = _cfgs(overrides)
    t = jcfg.train
    sched = optax.warmup_cosine_decay_schedule(
        0.0, t.lr, t.warmup_steps, max(t.steps, t.warmup_steps + 1),
        t.lr * 0.1)
    got = make_schedule(cfg)
    for count in range(0, 301):
        assert abs(got(count) - float(sched(count))) <= 1e-9, count
    assert got(0) == 0.0 or t.warmup_steps == 0


def _jax_steps(jcfg, params, batch, n):
    model = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg)
    state = JaxTrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    step = jax.jit(jax_make_train_step(jcfg, model))
    out = []
    for _ in range(n):
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    _as_port(state.params)))
    return out


@pytest.mark.parametrize("overrides", [
    {}, {"train.grad_accum": 2},
    {"train.keypoint_diversity": 0.05, "train.diversity_steps": 2}],
    ids=["plain", "grad_accum2", "diversity-annealed"])
def test_train_step_matches_jax_temporal(overrides):
    """1 and 3 steps from the same params and pairs: loss and grad_norm
    within 1e-5 relative, parameters within 1e-5 (``NOISE_GRADIENT``
    within the learning rates' sum)."""
    jcfg, cfg = _cfgs({**TEMPORAL, **overrides})
    params = random_flax_params(cfg, 0)
    src, tgt = random_images(4, cfg, 1), random_images(4, cfg, 2)
    want = _jax_steps(jcfg, params, (jnp.asarray(src), jnp.asarray(tgt)), 3)
    state = init_state(cfg, "cpu")
    load_model_state(state.model, state_dict_from_flax(params))
    step = make_train_step(cfg)
    lr_sum = sum(make_schedule(cfg)(i) for i in range(3))
    for i, (loss_j, norm_j, params_j) in enumerate(want):
        state, metrics = step(state, (torch.from_numpy(src),
                                      torch.from_numpy(tgt)))
        assert metrics["loss"].item() == pytest.approx(loss_j, rel=1e-5)
        assert metrics["grad_norm"].item() == pytest.approx(norm_j, rel=1e-5)
        if i in (0, 2):
            for name, p in state.model.state_dict().items():
                tol = 2 * lr_sum if name in NOISE_GRADIENT else 1e-5
                np.testing.assert_allclose(p.numpy(), params_j[name],
                                           rtol=0, atol=tol,
                                           err_msg=f"step {i + 1} {name}")
    assert state.step == 3


# --- full width, warp mode, on JAX's draws: the committed reference ------------

FULL = {"train.compute_dtype": "float32"}


def record_step_draws(key, batch: int, wcfg, fields: list,
                      warp_draws: list, factors: list) -> None:
    """Append what JAX's ``_warped_pair`` draws from a step's ``key`` (the
    same splits): its two warp fields, the TPS noise and affine draws they
    come from, and the two sets of jitter factors, as JSON-ready lists."""
    ks, kt, kc_s, kc_t = jax.random.split(key, 4)
    fields.append([np.asarray(random_warp_field(k, batch, wcfg))
                   for k in (ks, kt)])
    warp_draws.append([[t.numpy().ravel().tolist()
                        for t in jax_warp_draws(k, batch, wcfg)]
                       for k in (ks, kt)])
    factors.append([[np.asarray(_factor(k, s, batch, jnp.float32)).ravel()
                     .tolist() for k, s in zip(
                         jax.random.split(kc, 3),
                         (wcfg.brightness, wcfg.contrast, wcfg.saturation))]
                    for kc in (kc_s, kc_t)])


def jax_train_reference() -> dict:
    """JAX f32 full-width celeba128: 3 warp-mode train steps at b2 from
    ``random_flax_params(cfg, 0)`` and ``random_images(2, cfg, 1)`` (the same
    batch each step), with the warps (as fields, and as the TPS noise and
    affine draws they came from) and jitter factors each step drew."""
    ref = {"preset": "celeba128", "overrides": FULL, "param_seed": 0,
           "image_seed": 1, "batch": 2, "steps": 3, "rng_seed": 2}
    jcfg, cfg = _cfgs(FULL)
    wcfg = jax_warp_config(jcfg)
    params = random_flax_params(cfg, ref["param_seed"])
    images = jnp.asarray(random_images(ref["batch"], cfg, ref["image_seed"]))
    b, c = images.shape[:2]
    model = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg)
    state = JaxTrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    step = jax.jit(jax_make_train_step(jcfg, model))
    rng = jax.random.PRNGKey(ref["rng_seed"])
    fields, warp_draws, factors, losses, norms = [], [], [], [], []
    for i in range(ref["steps"]):
        record_step_draws(jax.random.fold_in(rng, i), b, wcfg, fields,
                          warp_draws, factors)
        if i == 0:
            src, tgt = make_pair(jax.random.fold_in(rng, 0), images, wcfg)

            def loss(p):
                recon, kp = model.apply({"params": p}, src, tgt)
                return jnp.mean((recon - tgt) ** 2), kp

            (_, kp), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                params)
            ref["keypoints"] = np.asarray(kp).tolist()
            ref["grad_norms"] = {k: float(np.linalg.norm(v))
                                 for k, v in _as_port(grads).items()}
        state, metrics = step(state, images, rng)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    fields = np.asarray(fields, np.float32)
    ref.update(fields_shape=list(fields.shape), fields=encode_f32(fields),
               warp_draws=warp_draws, factors=factors, loss=losses,
               grad_norm=norms)
    return ref


@pytest.fixture(scope="module")
def fresh_reference():
    return jax_train_reference()


def _flat(nested) -> np.ndarray:
    """A nest of lists of numbers (ragged or not) as one flat array."""
    if isinstance(nested, list):
        return np.concatenate([_flat(x) for x in nested] or [np.zeros(0)])
    return np.asarray([nested], np.float64)


def test_committed_train_reference_is_current(fresh_reference):
    committed = json.loads(REFERENCE.read_text())
    numbers = ("fields", "warp_draws", "factors", "loss", "grad_norm",
               "keypoints", "grad_norms")
    assert {k: v for k, v in committed.items() if k not in numbers} == \
        {k: v for k, v in fresh_reference.items() if k not in numbers}
    shape = committed["fields_shape"]
    np.testing.assert_allclose(decode_f32(fresh_reference["fields"], shape),
                               decode_f32(committed["fields"], shape),
                               atol=1e-6)
    for key in ("warp_draws", "factors", "loss", "grad_norm", "keypoints"):
        np.testing.assert_allclose(_flat(fresh_reference[key]),
                                   _flat(committed[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    assert fresh_reference["grad_norms"].keys() == committed["grad_norms"].keys()
    for name, value in committed["grad_norms"].items():
        assert fresh_reference["grad_norms"][name] == pytest.approx(
            value, rel=1e-5), name


def test_full_width_steps_on_jax_draws_match_jax(fresh_reference):
    """Full-width celeba128 in f32, warp mode, 3 steps at b2 on JAX's warps
    and factors: losses within 1e-5 relative, grad norms within 1e-4
    relative (measured 3.5e-5: the deep f32 sums run in another order),
    per-parameter gradient norms of step 1 by ``grad_norm_tolerance``."""
    ref = fresh_reference
    _, cfg = _cfgs(ref["overrides"])
    state = init_state(cfg, "cpu")
    load_model_state(state.model, state_dict_from_flax(
        random_flax_params(cfg, ref["param_seed"])))
    images = torch.from_numpy(random_images(ref["batch"], cfg,
                                            ref["image_seed"]))
    step = make_train_step(cfg)
    for i, draws in enumerate(reference_draws(ref)):
        state, metrics = step(state, images, draws)
        assert metrics["loss"].item() == pytest.approx(ref["loss"][i],
                                                       rel=1e-5)
        assert metrics["grad_norm"].item() == pytest.approx(
            ref["grad_norm"][i], rel=1e-4)
        if i == 0:
            got = {k: p.grad.norm().item()
                   for k, p in state.model.named_parameters()}
            assert got.keys() == ref["grad_norms"].keys()
            for name, value in ref["grad_norms"].items():
                assert abs(got[name] - value) <= grad_norm_tolerance(
                    value, ref["grad_norm"][0]), name


def test_full_width_keypoints_on_jax_draws_match_jax(fresh_reference):
    ref = fresh_reference
    _, cfg = _cfgs(ref["overrides"])
    model = _port_model(cfg, random_flax_params(cfg, ref["param_seed"]))
    images = torch.from_numpy(random_images(ref["batch"], cfg,
                                            ref["image_seed"]))
    src, tgt = pair_from_draws(images, reference_draws(ref)[0],
                               warp_config(cfg))
    with torch.no_grad():
        _, kp = model(src, tgt)
    np.testing.assert_allclose(kp.numpy(), ref["keypoints"], rtol=0,
                               atol=1e-4)


def test_reference_fields_follow_from_its_warp_draws(fresh_reference):
    """The port's TPS turns the committed draws into the committed fields
    (3e-5: JAX's own f32 field error, see test_torch_augment)."""
    ref = fresh_reference
    _, cfg = _cfgs(ref["overrides"])
    fields = decode_f32(ref["fields"], ref["fields_shape"])
    for i, step_draws in enumerate(reference_warp_draws(ref)):
        for j, draws in enumerate(step_draws):
            np.testing.assert_allclose(
                warp_field(draws, warp_config(cfg)).numpy(), fields[i, j],
                rtol=0, atol=3e-5)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    REFERENCE.parent.mkdir(exist_ok=True)
    REFERENCE.write_text(json.dumps(jax_train_reference()) + "\n")
    print(f"wrote {REFERENCE} ({REFERENCE.stat().st_size} bytes)")
