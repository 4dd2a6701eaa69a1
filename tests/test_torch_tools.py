"""The port's tools on the CPU, against the JAX package's.

Video rendering (``video.py``: live and from an artifact, a frame batch
above the bucket, the ``.npz`` when cv2 is hidden, the CLI on a pong64
store, from an artifact and from an image folder), eval's ``--overlay``
grid, ``utils.debug`` and ``utils.profiling`` on JAX's cases, and the
real-footage ingest copies of ``data.records`` (image folders and video
clips) against JAX's, byte for byte.
"""

import builtins
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keypoints_tpu import video as jvideo
from keypoints_tpu import viz as jviz
from keypoints_tpu.data import records as jrecords
from keypoints_tpu.utils import debug as jdebug
from keypoints_tpu_torch import eval as peval
from keypoints_tpu_torch import export, video
from keypoints_tpu_torch.checkpoint import state_dict_from_flax
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data import records
from keypoints_tpu_torch.data.collect import collect
from keypoints_tpu_torch.testing import random_flax_params, share_cpu_threads
from keypoints_tpu_torch.utils import debug, profiling

share_cpu_threads()

# pong64's structure at 32² with narrow filters, f32
SMALL = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
         "model.decoder_filters": (16, 8),
         "model.decoder_upsample": (True, True), "model.groups": 4,
         "data.image_size": 32, "train.compute_dtype": "float32"}


def _args(overrides: dict) -> list:
    return [f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in overrides.items()]


def _hide_cv2(monkeypatch) -> None:
    """``import cv2`` raises ImportError until the test ends."""
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    monkeypatch.delitem(sys.modules, "cv2", raising=False)


def _count_frames(path: str) -> int:
    import cv2
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.fixture(scope="module")
def pong(tmp_path_factory):
    """A 24-frame scripted-Pong store at 32², pong64's narrow config and
    seeded params as a state dict."""
    tmp = tmp_path_factory.mktemp("pong")
    path = collect(str(tmp / "atari_32.npy"), env_name=None, episodes=1,
                   steps_per_episode=24, size=32, delta=1, device="cpu")
    cfg = get_config("pong64").override(**SMALL)
    state = {k: torch.from_numpy(v) for k, v in
             state_dict_from_flax(random_flax_params(cfg, 0)).items()}
    return path, cfg, state


def test_render_live_writes_every_frame(pong, tmp_path):
    path, cfg, state = pong
    frames = np.asarray(records.FrameStore(path).frames[:16])
    out = str(tmp_path / "tracked.mp4")
    n = video.render_keypoint_video(
        out, frames, video.live_extract(cfg, state, torch.device("cpu")),
        fps=10.0, batch=8)
    assert n == 16
    if os.path.exists(out):                      # codec present: read back
        assert _count_frames(out) == 16
    else:
        assert np.load(str(tmp_path / "tracked.npz"))["frames"].shape == (
            16, 32, 32, 3)


def test_render_from_artifact_above_the_bucket_and_npz(pong, tmp_path,
                                                       monkeypatch):
    """An artifact of bucket 4 given frame batches of 10 (split 4 + 4 + 2):
    the keypoints of the live extract of the same params; then the
    ``.npz`` when cv2 is hidden, equal bit for bit to the one JAX's
    ``render_keypoint_video`` writes with the same extractor."""
    path, cfg, state = pong
    ext = export.load_extract(export.export_extract(cfg, state, 4, "cpu"))
    live = video.live_extract(cfg, state, torch.device("cpu"))
    frames = np.asarray(records.FrameStore(path).frames[:10])
    imgs = frames.astype(np.float32) / 255.0
    np.testing.assert_allclose(ext(imgs), live(imgs), rtol=0, atol=1e-6)
    assert video.render_keypoint_video(str(tmp_path / "a.avi"), frames, ext,
                                       batch=10) == 10

    _hide_cv2(monkeypatch)
    for mod, name in ((video, "b"), (jvideo, "j")):
        out = str(tmp_path / f"{name}.mp4")
        assert mod.render_keypoint_video(out, frames, ext, batch=4) == 10
        assert not os.path.exists(out)
    got = np.load(str(tmp_path / "b.npz"))["frames"]
    assert got.shape == (10, 32, 32, 3)
    np.testing.assert_array_equal(got,
                                  np.load(str(tmp_path / "j.npz"))["frames"])


@pytest.mark.parametrize("source", ["live", "artifact", "folder"])
def test_video_cli(pong, tmp_path, capsys, source):
    """``python -m keypoints_tpu_torch.video`` on the pong64 store: live
    from a state dict, from an exported artifact, and from an image folder
    of the store's frames."""
    path, cfg, state = pong
    out = str(tmp_path / "v.avi")
    argv = ["--preset", "pong64", "--out", out, "--frames", "8", "--batch",
            "4", "--device", "cpu", "--override", *_args(SMALL)]
    if source == "folder":
        import cv2
        folder = tmp_path / "frames"
        folder.mkdir()
        for i, f in enumerate(records.FrameStore(path).frames[:8]):
            cv2.imwrite(str(folder / f"{i:03d}.png"), f[0])
        argv += ["--folder", str(folder)]
    else:
        argv += ["--store", path]
    if source == "artifact":
        art = tmp_path / "e.pt2"
        art.write_bytes(export.export_extract(cfg, state, 4, "cpu"))
        argv += ["--artifact", str(art)]
    else:
        ckpt = tmp_path / "sd.pt"
        torch.save(state, ckpt)
        argv += ["--checkpoint", str(ckpt)]
    assert video.main(argv) == 8
    assert "wrote 8 frames" in capsys.readouterr().out


def test_overlay_equals_jax_grid_bit_for_bit(tmp_path):
    """``write_overlay`` (eval ``--overlay``) on seeded images and
    keypoints, in and out of bounds: the PNG holds JAX's
    ``image_grid(overlay_keypoints(...), cols=4)`` exactly."""
    import cv2
    rs = np.random.RandomState(3)
    images = rs.rand(6, 3, 24, 20).astype(np.float32)
    kp = (rs.rand(6, 5, 2) * 2.4 - 1.2).astype(np.float32)
    path = str(tmp_path / "o.png")
    peval.write_overlay(path, torch.from_numpy(images), kp)
    grid = jviz.image_grid(jviz.overlay_keypoints(images, kp), cols=4)
    np.testing.assert_array_equal(
        cv2.imread(path), (grid[..., ::-1] * 255).astype(np.uint8))


def test_eval_checkpoint_overlay_draws_the_models_keypoints(pong, tmp_path):
    """``eval --checkpoint --overlay``: the grid of the first 8 targets
    with the model's own keypoints, as JAX draws it."""
    import cv2
    path, cfg, state = pong
    ckpt = tmp_path / "sd.pt"
    torch.save(state, ckpt)
    png = str(tmp_path / "o.png")
    over = {**SMALL, "data.data_dir": str(tmp_path / "none")}
    peval.main(["--preset", "pong64", "--checkpoint", str(ckpt), "--device",
                "cpu", "--batch", "8", "--overlay", png, "--override",
                *_args(over)])
    _, tgt, *_ = peval.eval_batch_for(cfg.override(**over), 8,
                                      torch.Generator().manual_seed(7))
    kp = video.live_extract(cfg, state, torch.device("cpu"))(tgt.numpy())
    grid = jviz.image_grid(jviz.overlay_keypoints(tgt.numpy(), kp), cols=4)
    got = cv2.imread(png)
    assert got.shape == (2 * 32, 4 * 32, 3)
    np.testing.assert_array_equal(got,
                                  (grid[..., ::-1] * 255).astype(np.uint8))


# --- utils.debug and utils.profiling -------------------------------------------

NAN = float("nan")
TREES = {
    "nested": {"b": {"c": [0.0, 1.0]}, "a": [1.0, NAN]},
    "state dict": {"keynet.head.weight": [[1.0, np.inf]],
                   "encoder.Conv_0.bias": [NAN, NAN, 2.0]},
    "list": [[1.0], {"x": [2.0, -np.inf]}],
}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and not isinstance(tree[0], float):
        return [_torch_tree(v) for v in tree]
    return torch.tensor(tree, dtype=torch.float32)


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and not isinstance(tree[0], float):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree, jnp.float32)


@pytest.mark.parametrize("case", sorted(TREES))
def test_assert_finite_names_the_leaf_as_jax(case):
    with pytest.raises(FloatingPointError) as want:
        jdebug.assert_finite(_jax_tree(TREES[case]), "params")
    with pytest.raises(FloatingPointError) as got:
        debug.assert_finite(_torch_tree(TREES[case]), "params")
    assert str(got.value) == str(want.value)
    ok = {"a": torch.ones(3), "b": {"c": torch.zeros(2, dtype=torch.bfloat16)}}
    debug.assert_finite(ok)
    debug.assert_finite(torch.nn.Linear(2, 3).state_dict())


def test_guard_metrics_raises_on_a_nan_metric_as_jax():
    step = lambda state, batch, rng: (state, {"loss": batch})  # noqa: E731
    ours, theirs = debug.guard_metrics(step), jdebug.guard_metrics(step)
    state, metrics = ours(1, torch.tensor(0.5), None)
    assert state == 1
    ours.check(metrics)
    bad = {"grad_norm": torch.tensor(1.0), "loss": torch.tensor(NAN)}
    with pytest.raises(FloatingPointError) as got:
        ours.check(bad)
    with pytest.raises(FloatingPointError) as want:
        theirs.check({k: np.asarray(v) for k, v in bad.items()})
    assert str(got.value) == str(want.value)
    ours.check({"per_row": torch.tensor([NAN, 1.0])})   # not a scalar


@pytest.mark.parametrize("shape,dtype,ok", [
    ((2, 3, 8, 8), "float32", True), ((2, 3, 8, 8), "bfloat16", True),
    ((2, 1, 8, 8), "float32", False), ((2, 3, 8, 9), "float32", False),
    ((3, 8, 8), "float32", False), ((2, 3, 8, 8), "uint8", False)])
def test_assert_batch_as_jax(shape, dtype, ok):
    x = torch.zeros(shape, dtype=getattr(torch, dtype))
    jx = jnp.zeros(shape, getattr(jnp, dtype))
    if ok:
        debug.assert_batch(x, channels=3, size=8)
        jdebug.assert_batch(jx, channels=3, size=8)
        return
    with pytest.raises(AssertionError):
        jdebug.assert_batch(jx, channels=3, size=8)
    with pytest.raises(AssertionError):
        debug.assert_batch(x, channels=3, size=8)


def test_timed_fetch_sync_and_step_timer():
    dt, out = profiling.timed(lambda x: x * 2, torch.ones(16), reps=2)
    assert dt >= 0 and torch.equal(out, torch.full((16,), 2.0))
    profiling.fetch_sync({"a": out, "b": [torch.zeros(0), 3]})
    t = profiling.StepTimer(batch_size=10)
    assert t.mark(5) > 0


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / "raised")):
            raise ValueError("inside")
    assert (tmp_path / "raised" / "trace.json").exists()


# --- the ingest copies (ROADMAP A.7) -------------------------------------------

def _png_folder(path: Path, n: int = 5) -> str:
    """``n`` seeded RGB PNGs of assorted sizes, and a file that is none."""
    import cv2
    path.mkdir()
    rs = np.random.RandomState(9)
    for i in range(n):
        h, w = 20 + 7 * i, 31 - 3 * i
        cv2.imwrite(str(path / f"img{i}.png"),
                    rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
    (path / "notes.txt").write_text("not an image")
    return str(path)


def _clip(path: Path, n: int, seed: int, w: int = 40, h: int = 28) -> None:
    """An MJPG clip of ``n`` seeded frames, 40×28 (cropped to 28²)."""
    import cv2
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (w, h))
    assert wr.isOpened(), "cv2 cannot write MJPG here"
    rs = np.random.RandomState(seed)
    for _ in range(n):
        wr.write(rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
    wr.release()


def _store_files(path: str) -> dict:
    """The bytes of a store's frames, pair index and sidecar (None where a
    file is absent)."""
    files = (records.store_path(path), records.pairs_path(path),
             records.meta_path(path))
    return {os.path.basename(f).replace("jax_", ""):
            Path(f).read_bytes() if os.path.exists(f) else None
            for f in files}


@pytest.mark.parametrize("channels", [3, 1])
def test_image_folder_ingest_equals_jax(tmp_path, channels):
    folder = _png_folder(tmp_path / "imgs")
    for limit in (None, 3):
        np.testing.assert_array_equal(
            records.load_image_folder(folder, 16, channels, limit),
            jrecords.load_image_folder(folder, 16, channels, limit))
    ours = records.image_folder_to_store(folder, str(tmp_path / "s.npy"), 16,
                                         channels)
    theirs = jrecords.image_folder_to_store(
        folder, str(tmp_path / "jax_s.npy"), 16, channels)
    assert _store_files(ours) == _store_files(theirs)
    assert records.FrameStore(ours).frames.shape == (5, channels, 16, 16)


@pytest.mark.parametrize("channels,stride,delta", [(3, 1, 1), (1, 2, 2),
                                                   (3, 1, 9)])
def test_video_ingest_equals_jax(tmp_path, channels, stride, delta):
    clips = tmp_path / "clips"
    clips.mkdir()
    _clip(clips / "a.avi", 7, 1)
    _clip(clips / "b.avi", 5, 2)
    np.testing.assert_array_equal(
        records.load_video(str(clips / "a.avi"), 16, channels, stride, 4),
        jrecords.load_video(str(clips / "a.avi"), 16, channels, stride, 4))
    ours = records.video_to_store(str(clips), str(tmp_path / "v.npy"), 16,
                                  channels, stride, delta)
    theirs = jrecords.video_to_store(str(clips), str(tmp_path / "jax_v.npy"),
                                     16, channels, stride, delta)
    assert _store_files(ours) == _store_files(theirs)
    store = records.FrameStore(ours)
    assert (store.pairs is None) == (delta == 9)
