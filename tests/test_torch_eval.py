"""The port's evaluation path against the JAX package's (CPU).

``keypoint_metrics``, the faces and pose renderers, ``eval_field_at`` /
``invert_warp_at``, ``make_pair_with_positions`` on JAX's draws,
``evaluate`` at a narrow config with the same weights, bulk extraction,
``eval_batch_for``'s routes and the ``python -m keypoints_tpu_torch.eval``
CLI on the CPU. ``jax.random`` and torch never draw the same numbers, so
the pair is made from the fields and jitter factors JAX drew (the key
splits of ``keypoints_tpu.data.augment._warped_pair``).

``python tests/test_torch_eval.py`` rewrites the committed JAX reference
``tests/data/torch_port_celeba128_eval.json``: JAX's eval of full-width
celeba128 in f32 on a b4 synthetic-faces batch, with its draws
(``chip_smoke.py`` holds the card to it, where JAX is not installed). A test
below regenerates it and fails when it goes stale.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keypoints_tpu import eval as jeval
from keypoints_tpu.configs import get_config as jax_get_config
from keypoints_tpu.data import faces as jfaces
from keypoints_tpu.data import pose as jpose
from keypoints_tpu.data.augment import (make_pair_with_positions,
                                        random_warp_field)
from keypoints_tpu.ops import warp as jwarp
from keypoints_tpu.ops.color import _factor
from keypoints_tpu.training import warp_config as jax_warp_config
from keypoints_tpu_torch import eval as peval
from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data import faces, pose
from keypoints_tpu_torch.data.augment import pair_with_positions_from_draws
from keypoints_tpu_torch.ops import warp
from keypoints_tpu_torch.testing import (decode_f32, encode_f32,
                                         random_flax_params,
                                         reference_draws,
                                         reference_eval_batch,
                                         share_cpu_threads)
from keypoints_tpu_torch.training import (build_model, make_extract_fn,
                                          make_extract_many_fn, warp_config)

share_cpu_threads()

REFERENCE = Path(__file__).parent / "data" / "torch_port_celeba128_eval.json"
# celeba128's structure at 64² with narrow filters, f32: the coarse-field
# warp applies (33 < 64)
NARROW = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
          "model.decoder_filters": (16, 8),
          "model.decoder_upsample": (True, True), "model.groups": 4,
          "data.image_size": 64, "train.compute_dtype": "float32"}
FULL = {"train.compute_dtype": "float32"}
RECORD_KEYS = {"preset", "step", "metrics"}      # + the info keys, from JAX


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _cfgs(overrides: dict, preset: str = "celeba128"):
    return (jax_get_config(preset).override(**overrides),
            get_config(preset).override(**overrides))


# JAX's TPS field jitted once (op by op it takes seconds on a CPU)
_jax_field = jax.jit(random_warp_field, static_argnums=(1, 2))


def _pair_and_draws(key, frames, marks, wcfg):
    pair = make_pair_with_positions(key, frames, marks, wcfg)
    b, c = frames.shape[:2]
    ks, kt, kc_s, kc_t = jax.random.split(key, 4)
    fields = [random_warp_field(k, b, wcfg) for k in (ks, kt)]
    strengths = (wcfg.brightness, wcfg.contrast, wcfg.saturation)
    factors = [[_factor(k, s, b, jnp.float32).ravel()
                for k, s in zip(jax.random.split(kc, 3), strengths)][
                   :3 if c == 3 else 2] for kc in (kc_s, kc_t)]
    return pair, fields, factors


_jax_pair_and_draws = jax.jit(_pair_and_draws, static_argnums=(3,))


def jax_pair_and_draws(key, frames, marks, wcfg):
    """JAX's ``make_pair_with_positions(key, frames, marks)`` under jit, as
    ``synthetic_eval_batch`` runs it, and what it draws: its two warp fields
    and each side's (brightness, contrast, saturation) factors, by the key
    splits of ``_warped_pair``, in the same jit (so XLA computes the fields
    it records and the fields it warps with alike) → ((src, tgt, positions),
    the draws in the layout ``testing.reference_draws`` reads)."""
    pair, fields, factors = _jax_pair_and_draws(
        key, jnp.asarray(frames), jnp.asarray(marks), wcfg)
    return pair, _draws_ref(
        [np.asarray(f) for f in fields],
        [[np.asarray(f).tolist() for f in side] for side in factors])


def jax_evaluate(jcfg, params, src, tgt, pos):
    """JAX's ``evaluate`` and the keypoints its forward pass scored (taken
    where it hands them to ``keypoint_metrics``)."""
    seen = []
    metrics_of = jeval.keypoint_metrics

    def keep(kp, true_positions=None):
        seen.append(kp)
        return metrics_of(kp, true_positions)
    jeval.keypoint_metrics = keep
    try:
        metrics = jeval.evaluate(jcfg, params, src, tgt, true_positions=pos)
    finally:
        jeval.keypoint_metrics = metrics_of
    return metrics, np.asarray(seen[0])


def jax_route_info(jcfg, batch: int) -> dict:
    """The ``info`` record of JAX's ``eval_batch_for`` for ``jcfg``: its
    routing, with the generator it routes to stubbed out."""
    synth = jeval.synthetic_eval_batch
    jeval.synthetic_eval_batch = lambda cfg, b, key: (np.zeros(b), None, None)
    try:
        return jeval.eval_batch_for(jcfg, batch, jax.random.PRNGKey(7))[3]
    finally:
        jeval.synthetic_eval_batch = synth


def _draws_ref(fields, factors) -> dict:
    """The draws in the layout ``testing.reference_draws`` reads (one step)."""
    fields = np.asarray([fields], np.float32)
    return {"steps": 1, "fields_shape": list(fields.shape),
            "fields": encode_f32(fields), "factors": [factors]}


# --- metrics and renderers ----------------------------------------------------

@pytest.mark.parametrize("with_truth", [False, True])
def test_keypoint_metrics_match_jax(with_truth):
    rs = np.random.RandomState(3)
    kp = (rs.rand(5, 6, 2) * 2.4 - 1.2).astype(np.float32)
    truth = (rs.rand(5, 4, 2) * 2 - 1).astype(np.float32) if with_truth else None
    got = peval.keypoint_metrics(kp, truth)
    want = jeval.keypoint_metrics(kp, truth)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_faces_equal_jax_to_the_bit():
    imgs, marks = faces.render_faces(3, 32, np.random.RandomState(5))
    want_imgs, want_marks = jfaces.render_faces(3, 32,
                                                np.random.RandomState(5))
    assert imgs.shape == (3, 3, 32, 32) and marks.shape == (3, 4, 2)
    np.testing.assert_array_equal(imgs, want_imgs)
    np.testing.assert_array_equal(marks, want_marks)


def test_pose_episode_and_frames_match_jax():
    segs = pose.generate_episode(4, np.random.RandomState(6))
    want = jpose.generate_episode(4, np.random.RandomState(6))
    np.testing.assert_array_equal(segs, want)
    np.testing.assert_array_equal(pose.joint_positions(segs),
                                  jpose.joint_positions(want))
    frames = pose._render_episode(segs, 32)
    assert frames.shape == (4, 3, 32, 32) and frames.dtype == torch.float32
    np.testing.assert_allclose(frames.numpy(),
                               jpose._render_episode(want, 32), atol=1e-5)


# --- landmarks through the warp ---------------------------------------------

def test_eval_field_at_and_invert_warp_at_match_jax():
    key = jax.random.PRNGKey(8)
    wcfg = jax_warp_config(jax_get_config("celeba128"))
    field = np.asarray(_jax_field(key, 3, wcfg))
    pts = (np.random.RandomState(8).rand(3, 5, 2) * 1.8 - 0.9).astype(
        np.float32)
    for port, ref in ((warp.eval_field_at, jwarp.eval_field_at),
                      (warp.invert_warp_at, jwarp.invert_warp_at)):
        np.testing.assert_allclose(
            port(_t(field), _t(pts)).numpy(),
            np.asarray(jax.jit(ref)(jnp.asarray(field), jnp.asarray(pts))),
            atol=1e-6, err_msg=port.__name__)
    # at the dense grid's positions it is the upsampled field
    grid = warp.upsample_field_aligned(_t(field), 9, 9)
    pts = warp.coord_grid(9, 9).reshape(1, -1, 2).expand(3, -1, -1)
    np.testing.assert_allclose(warp.eval_field_at(_t(field), pts).numpy(),
                               grid.reshape(3, -1, 2).numpy(), atol=1e-6)


def test_pair_with_positions_on_jax_draws_matches_jax():
    """64² RGB faces: the pair within 1e-5, the carried landmarks within
    1e-5 of JAX's ``make_pair_with_positions`` on the same key."""
    jcfg, cfg = _cfgs(NARROW)
    wcfg = jax_warp_config(jcfg)
    imgs, marks = faces.render_faces(3, 64, np.random.RandomState(9))
    (src, tgt, pos), ref = jax_pair_and_draws(jax.random.PRNGKey(9), imgs,
                                              marks, wcfg)
    draws = reference_draws(ref)[0]
    got = pair_with_positions_from_draws(_t(imgs), _t(marks), draws,
                                         warp_config(cfg))
    for g, w in zip(got, (src, tgt, pos)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # the landmarks moved: the target warp is not the identity
    assert np.abs(np.asarray(pos) - marks).max() > 1e-2


# --- evaluate -----------------------------------------------------------------

@pytest.fixture(scope="module")
def narrow_eval():
    """JAX's eval of a narrow 64² celeba128 on its own eval batch, and the
    port's model with the same weights on that batch."""
    jcfg, cfg = _cfgs(NARROW)
    params = random_flax_params(cfg, 0)
    key = jax.random.PRNGKey(11)
    src, tgt, pos = jeval.synthetic_eval_batch(jcfg, 4, key)
    want, kp = jax_evaluate(jcfg, params, src, tgt, pos)
    model = build_model(cfg, "cpu")
    load_model_state(model, state_dict_from_flax(params))
    return model, tuple(_t(a) for a in (src, tgt)), np.asarray(pos), want, \
        np.asarray(kp)


def test_evaluate_matches_jax(narrow_eval):
    model, (src, tgt), pos, want, want_kp = narrow_eval
    got = peval.evaluate(model, src, tgt, true_positions=pos)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-4)
    _, kp = peval.eval_forward(model, src, tgt)
    np.testing.assert_allclose(kp.numpy(), want_kp, atol=1e-4)
    for k in ("keypoint_spread", "locking_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_coordinate_parity_of_the_same_weights(narrow_eval):
    model, (src, _), *_ = narrow_eval
    golden = make_extract_fn(model)
    assert peval.coordinate_parity(model, lambda x: golden(_t(x)).numpy(),
                                   src.numpy()) == 0.0


def test_extract_many_equals_per_batch(narrow_eval):
    model, (src, tgt), *_ = narrow_eval
    images = torch.stack([src[:2], tgt[:2], src[2:]])            # (3, 2, ...)
    got = make_extract_many_fn(model)(images)
    extract = make_extract_fn(model)
    assert got.shape == (3, 2, 10, 2)
    for i in range(3):
        torch.testing.assert_close(got[i], extract(images[i]), rtol=0, atol=0)


# --- routes and the CLI --------------------------------------------------------

# (preset, overrides, landmarks, the pair is the frames twice)
ROUTES = [("celeba128", {"data.image_size": 32}, 4, True),   # below 33²
          ("celeba128", {"data.image_size": 64}, 4, False),
          ("pose256", {"data.image_size": 32}, 16, True),
          ("pong64", {}, 3, False),
          ("transporter_atari", {}, 3, False),
          ("celeba128", {"data.dataset": "synthetic_dots",
                         "data.image_size": 32}, 10, False)]


@pytest.mark.parametrize("preset,overrides,marks,identity", ROUTES)
def test_synthetic_eval_sets_route_as_jax(preset, overrides, marks, identity,
                                          tmp_path):
    """With no store on disk every preset scores its synthetic set: the
    record JAX writes, frames in [0, 1] and ground truth of the set's
    landmark count."""
    overrides = {**overrides, "data.data_dir": str(tmp_path)}
    jcfg, cfg = _cfgs(overrides, preset)
    want_info = jax_route_info(jcfg, 2)
    src, tgt, pos, info = peval.eval_batch_for(
        cfg, 2, torch.Generator().manual_seed(7))
    assert info == want_info
    size, ch = cfg.data.image_size, cfg.data.channels
    assert src.shape == tgt.shape == (2, ch, size, size)
    assert 0.0 <= float(src.min()) and float(tgt.max()) <= 1.0
    assert pos.shape == (2, marks, 2) and np.isfinite(pos).all()
    assert torch.equal(src, tgt) == identity


@pytest.mark.parametrize("frames", [4, 64])      # below / above a holdout
def test_stores_route_to_the_store_or_the_generator(frames, tmp_path):
    """A store without a sidecar is scored from the store (its held-out
    tail, with JAX's ``info``, here the frames twice at 32²); a store whose
    sidecar names the synthetic origin takes the generator, as in JAX."""
    jcfg, cfg = _cfgs({"data.image_size": 32, "data.data_dir": str(tmp_path)})
    np.save(tmp_path / "celeba_32.npy",
            (np.random.RandomState(0).rand(frames, 3, 32, 32) * 255).astype(
                np.uint8))
    src, tgt, pos, info = peval.eval_batch_for(
        cfg, 2, torch.Generator().manual_seed(7))
    jsrc, jtgt, jpos, jinfo = jeval.eval_batch_for(jcfg, 2,
                                                   jax.random.PRNGKey(7))
    assert info == jinfo and info["source"] == "store"
    assert info["held_out"] == (frames == 64)
    assert pos is None and jpos is None
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))
    (tmp_path / "celeba_32_meta.json").write_text(
        json.dumps({"origin": "synthetic_faces"}))
    *_, info = peval.eval_batch_for(cfg, 2, torch.Generator().manual_seed(7))
    assert info == jax_route_info(jcfg, 2) and info["source"] == "synthetic"


# transporter_atari's structure at 32² with narrow filters, f32
NARROW_ATARI = {**NARROW, "data.image_size": 32}


def _atari_store(tmp_path) -> str:
    """64 seeded 1-channel 32² frames, two episodes, Δ = 2: 60 pairs, the
    last 15 held out; no sidecar, as the committed data/atari_64.npy."""
    from keypoints_tpu_torch.data.records import FrameStore, episode_pairs
    frames = (np.random.RandomState(12).rand(64, 1, 32, 32) * 255).astype(
        np.uint8)
    FrameStore.write(str(tmp_path / "atari_32.npy"), frames,
                     episode_pairs([32, 32], 2))
    return str(tmp_path)


def test_store_eval_temporal_matches_jax(tmp_path):
    """Temporal store eval uses no randomness: the clamped tail pairs and
    ``info`` equal JAX's exactly; ``evaluate`` on the same weights within
    eval_loss rel 1e-5 and keypoints 1e-4; the trainer's scoring pair is
    the last rows of the same tail."""
    from keypoints_tpu import train as jtrain
    from keypoints_tpu_torch import train as ptrain
    over = {**NARROW_ATARI, "data.data_dir": _atari_store(tmp_path)}
    jcfg, cfg = _cfgs(over, "transporter_atari")
    src, tgt, pos, info = peval.eval_batch_for(
        cfg, 64, torch.Generator().manual_seed(7))
    jsrc, jtgt, jpos, jinfo = jeval.eval_batch_for(jcfg, 64,
                                                   jax.random.PRNGKey(7))
    assert info == jinfo == {"source": "store", "held_out": True,
                             "rows": 15, "requested_rows": 64, "gt": None}
    assert pos is None and jpos is None
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))
    for got, want in zip(ptrain.heldout_scoring_pair(cfg, "cpu"),
                         jtrain.heldout_scoring_pair(jcfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    params = random_flax_params(cfg, 0)
    want, want_kp = jax_evaluate(jcfg, params, jsrc, jtgt, None)
    model = build_model(cfg, "cpu")
    load_model_state(model, state_dict_from_flax(params))
    got = peval.evaluate(model, src, tgt)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-5)
    _, kp = peval.eval_forward(model, src, tgt)
    np.testing.assert_allclose(kp.numpy(), want_kp, atol=1e-4)


def test_store_eval_warp_with_landmarks_on_jax_draws_matches_jax(
        tmp_path, monkeypatch):
    """Warp-mode store eval with ``--landmarks``: JAX's pair of the tail
    frames, on its draws fed to the port (in place of the port's
    ``draw_pair``), within 1e-5, the landmarks carried into the target
    within 1e-5, the same ``info``."""
    jcfg, cfg = _cfgs({**NARROW, "data.data_dir": str(tmp_path)})
    rs = np.random.RandomState(13)
    frames = (rs.rand(40, 3, 64, 64) * 255).astype(np.uint8)
    marks = (rs.rand(40, 4, 2) * 1.6 - 0.8).astype(np.float32)
    np.save(tmp_path / "celeba_64.npy", frames)
    np.save(tmp_path / "marks.npy", marks)
    key = jax.random.PRNGKey(7)
    jsrc, jtgt, jpos, jinfo = jeval.eval_batch_for(
        jcfg, 4, key, landmarks_path=str(tmp_path / "marks.npy"))
    # the tail's 4 frames (of a 10-frame reserve), paired on JAX's draws
    tail = frames[-10:-6].astype(np.float32) / 255.0
    _, ref = jax_pair_and_draws(jax.random.fold_in(key, 1), tail,
                                marks[-10:-6], jax_warp_config(jcfg))
    from keypoints_tpu_torch.data import augment
    from keypoints_tpu_torch.data.records import FrameStore
    draw_pair = augment.draw_pair
    monkeypatch.setattr(augment, "draw_pair",
                        lambda *a, **k: reference_draws(ref)[0])
    src, tgt, pos, info = peval.store_eval_batch(
        cfg, FrameStore(str(tmp_path / "celeba_64.npy")), 4,
        torch.Generator().manual_seed(7), landmarks=marks)
    monkeypatch.setattr(augment, "draw_pair", draw_pair)
    assert info == jinfo == {"source": "store", "held_out": True, "rows": 4,
                             "requested_rows": 4, "gt": "landmarks"}
    for g, w in ((src, jsrc), (tgt, jtgt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(pos, np.asarray(jpos), atol=1e-5)
    # the port's own draws: a warped pair of the same tail, the same info
    src, tgt, pos, info = peval.eval_batch_for(
        cfg, 4, torch.Generator().manual_seed(7),
        landmarks_path=str(tmp_path / "marks.npy"))
    assert info == jinfo and pos.shape == (4, 4, 2) and src.shape == tgt.shape
    assert not torch.equal(src, tgt)
    with pytest.raises(SystemExit, match="does not apply"):
        peval.eval_batch_for(get_config("pong64"), 4, torch.Generator(),
                             landmarks_path=str(tmp_path / "marks.npy"))


def test_cli_scores_a_trainer_directory_on_the_store(tmp_path, capsys):
    """``--checkpoint`` of the trainer's directory: its newest step, scored
    on the store's held-out tail, the step in the record."""
    from keypoints_tpu_torch import train as ptrain
    data = _atari_store(tmp_path)
    over = {**NARROW_ATARI, "data.data_dir": data, "train.batch_size": 4,
            "train.steps": 4, "train.log_every": 2, "train.eval_every": 100,
            "train.checkpoint_every": 2,
            "train.checkpoint_dir": str(tmp_path / "ck")}
    state = ptrain.train(get_config("transporter_atari").override(**over),
                         device="cpu")
    overrides = [f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
                 for k, v in {**NARROW_ATARI, "data.data_dir": data}.items()]
    result = peval.main(["--preset", "transporter_atari", "--checkpoint",
                         str(tmp_path / "ck" / "transporter_atari"),
                         "--device", "cpu", "--override", *overrides])
    assert result["step"] == 4 and result["source"] == "store"
    assert result["held_out"] is True and result["rows"] == 15
    assert result["requested_rows"] == 64 and result["gt"] is None
    assert set(result["metrics"]) == {"eval_loss", "keypoint_spread",
                                      "keypoint_in_bounds"}
    cfg = get_config("transporter_atari").override(**NARROW_ATARI)
    src, tgt, *_ = peval.eval_batch_for(
        cfg.override(**{"data.data_dir": data}), 64,
        torch.Generator().manual_seed(7))
    want = peval.evaluate(state.model, src, tgt)["eval_loss"]
    assert result["metrics"]["eval_loss"] == want
    assert "(step 4)" in capsys.readouterr().out


def test_cli_on_cpu_writes_the_jax_record(tmp_path, capsys):
    jcfg, cfg = _cfgs({**NARROW, "data.data_dir": str(tmp_path)})
    ckpt = tmp_path / "sd.pt"
    torch.save({k: torch.from_numpy(v) for k, v in
                state_dict_from_flax(random_flax_params(cfg, 0)).items()},
               ckpt)
    out = tmp_path / "out.json"
    overrides = [f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
                 for k, v in {**NARROW, "data.data_dir": tmp_path}.items()]
    result = peval.main(["--preset", "celeba128", "--checkpoint", str(ckpt),
                         "--device", "cpu", "--batch", "4", "--json",
                         str(out), "--override", *overrides])
    info = jax_route_info(jcfg, 4)
    written = json.loads(out.read_text())
    assert written == result
    assert set(written) == RECORD_KEYS | set(info)
    assert written["step"] is None and written["source"] == "synthetic"
    assert written["held_out"] is True and written["rows"] == 4
    assert set(written["metrics"]) == {
        "eval_loss", "keypoint_spread", "keypoint_in_bounds",
        "locking_median", "locking_mean", "pck@0.1", "pck@0.2"}
    assert all(np.isfinite(v) for v in written["metrics"].values())
    assert capsys.readouterr().out.splitlines()[-2].startswith("result: ")


# --- the committed full-width reference ---------------------------------------

def jax_eval_reference() -> dict:
    """JAX's eval of full-width celeba128 in f32 (``random_flax_params(cfg,
    0)``) on its synthetic eval set of b4 at ``PRNGKey(7)``, the CLI's key:
    the faces' numpy seed, the pair's fields and jitter factors, the
    carried landmarks, the metrics and the keypoints."""
    ref = {"preset": "celeba128", "overrides": FULL, "param_seed": 0,
           "batch": 4, "key": 7}
    jcfg, cfg = _cfgs(FULL)
    wcfg = jax_warp_config(jcfg)
    key = jax.random.PRNGKey(ref["key"])
    # synthetic_eval_batch's celeba set: the faces of a numpy seed drawn
    # from the key, paired on fold_in(key, 1)
    seed = int(jax.random.randint(key, (), 0, 1 << 30))
    imgs, marks = jfaces.render_faces(ref["batch"], jcfg.data.image_size,
                                      np.random.RandomState(seed))
    (src, tgt, pos), draws = jax_pair_and_draws(jax.random.fold_in(key, 1),
                                                imgs, marks, wcfg)
    params = random_flax_params(cfg, ref["param_seed"])
    metrics, kp = jax_evaluate(jcfg, params, src, tgt, pos)
    ref.update(numpy_seed=seed, **draws,
               target_positions=encode_f32(np.asarray(pos)),
               metrics=metrics, keypoints=encode_f32(np.asarray(kp)))
    return ref


@pytest.fixture(scope="module")
def fresh_reference():
    return jax_eval_reference()


def test_committed_eval_reference_is_current(fresh_reference):
    committed = json.loads(REFERENCE.read_text())
    numbers = ("fields", "factors", "target_positions", "metrics",
               "keypoints")
    assert {k: v for k, v in committed.items() if k not in numbers} == \
        {k: v for k, v in fresh_reference.items() if k not in numbers}
    b = committed["batch"]
    for name, shape, tol in (("fields", committed["fields_shape"], 1e-6),
                             ("target_positions", (b, 4, 2), 1e-6),
                             ("keypoints", (b, 10, 2), 1e-5)):
        np.testing.assert_allclose(decode_f32(committed[name], shape),
                                   decode_f32(fresh_reference[name], shape),
                                   atol=tol, err_msg=name)
    for k, v in fresh_reference["metrics"].items():
        np.testing.assert_allclose(committed["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)


def test_full_width_eval_on_jax_draws_matches_jax():
    """The bars chip_smoke.py holds the card to, here on the CPU: carried
    landmarks within 1e-5, eval_loss rel 1e-4, keypoints within 1e-4."""
    ref = json.loads(REFERENCE.read_text())
    cfg = get_config(ref["preset"]).override(**ref["overrides"])
    src, tgt, pos = reference_eval_batch(ref, "cpu")
    b = ref["batch"]
    np.testing.assert_allclose(
        pos.numpy(), decode_f32(ref["target_positions"], (b, 4, 2)),
        atol=1e-5)
    model = build_model(cfg, "cpu")
    load_model_state(model, state_dict_from_flax(
        random_flax_params(cfg, ref["param_seed"])))
    got = peval.evaluate(model, src, tgt, true_positions=pos.numpy())
    np.testing.assert_allclose(got["eval_loss"],
                               ref["metrics"]["eval_loss"], rtol=1e-4)
    _, kp = peval.eval_forward(model, src, tgt)
    np.testing.assert_allclose(kp.numpy(),
                               decode_f32(ref["keypoints"], (b, 10, 2)),
                               atol=1e-4)


if __name__ == "__main__":
    REFERENCE.write_text(json.dumps(jax_eval_reference()) + "\n")
    print(f"wrote {REFERENCE}")
