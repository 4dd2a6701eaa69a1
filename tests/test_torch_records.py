"""The port's frame stores, streams, device sampling, collectors and store
writers against the JAX package's (CPU), and the streams' own contract.

Stores are written by one package and read by the other; the numpy-only
writers (faces, the scripted-Pong physics) must equal JAX's to the bit;
the rendered ones (pose figures, Pong frames) equal JAX's after its
``(clip * 255).astype(uint8)`` or differ by one level on at most 0.1 % of
the pixels (float rendering on two backends). The streams use no grain,
so they are held to their own contract: batch ``i`` a pure function of
``(seed, i)``, threaded equal to serial, each epoch a permutation of
``[0, limit)``.
"""

import json

import numpy as np
import pytest
import torch

import jax

from keypoints_tpu import train as jtrain
from keypoints_tpu.configs import get_config as jax_get_config
from keypoints_tpu.data import collect as jcollect
from keypoints_tpu.data import faces as jfaces
from keypoints_tpu.data import pose as jpose
from keypoints_tpu.data import records as jrecords
from keypoints_tpu.data import synthetic as jsynthetic
from keypoints_tpu_torch import train as ptrain
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data import collect, device, faces, pose, records
from keypoints_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

#: rendered stores: at most this share of pixels one uint8 level apart
QUANT_SHARE = 1e-3


def _frames(n=24, c=1, size=16, seed=0):
    return (np.random.RandomState(seed).rand(n, c, size, size) * 255).astype(
        np.uint8)


def _assert_store_equal(path_a, path_b):
    a, b = records.FrameStore(path_a), jrecords.FrameStore(path_b)
    np.testing.assert_array_equal(np.asarray(a.frames), np.asarray(b.frames))
    assert (a.pairs is None) == (b.pairs is None)
    if a.pairs is not None:
        np.testing.assert_array_equal(np.asarray(a.pairs),
                                      np.asarray(b.pairs))
    assert a.meta == b.meta


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_written_by_one_package_reads_equal_in_the_other(writer,
                                                               tmp_path):
    frames = _frames()
    pairs = records.episode_pairs([10, 14], 2)
    meta = {"origin": "scripted_pong", "seed": 3}
    write = (jrecords if writer == "jax" else records).FrameStore.write
    write(str(tmp_path / "store"), frames, pairs, meta=meta)
    path = str(tmp_path / "store.npy")
    _assert_store_equal(path, path)
    store = records.FrameStore(str(tmp_path / "store"))
    np.testing.assert_array_equal(store.frames, frames)
    np.testing.assert_array_equal(store.pairs, pairs)
    assert store.meta == meta and len(store) == len(pairs)
    # a frames-only rewrite removes the stale index and sidecar
    write(path, frames[:5])
    _assert_store_equal(path, path)
    assert records.FrameStore(path).pairs is None
    assert records.FrameStore(path).meta == {}


def test_store_paths_and_episode_pairs_match_jax():
    for p in ("d/atari_64", "d/atari_64.npy", "x.y"):
        assert records.store_path(p) == jrecords.store_path(p)
        assert records.pairs_path(p) == jrecords.pairs_path(p)
        assert records.meta_path(p) == jrecords.meta_path(p)
    for name in ("transporter_atari", "celeba128", "pose256"):
        d = get_config(name).data
        assert records.store_path_for(d) == jrecords.store_path_for(
            jax_get_config(name).data)
    for lengths, delta in (([5, 3, 7], 2), ([1, 1], 1), ([6], 1), ([], 2)):
        np.testing.assert_array_equal(
            records.episode_pairs(lengths, delta),
            jrecords.episode_pairs(lengths, delta))


@pytest.mark.parametrize("batch", [1, 4, 8, 16, 64])
def test_scoring_rows_and_holdout_match_jax(batch):
    over = {"train.batch_size": batch}
    cfg = get_config("celeba128").override(**over)
    jcfg = jax_get_config("celeba128").override(**over)
    assert ptrain.scoring_rows(cfg) == jtrain.scoring_rows(jcfg)
    # too small to reserve (n // 4 < the scoring rows), the 64 cap, between
    for n in (0, 7, 16, 31, 32, 33, 100, 255, 256, 257, 4440):
        assert ptrain.scoring_holdout(cfg, n) == jtrain.scoring_holdout(
            jcfg, n), n


@pytest.mark.parametrize("pair_mode", ["temporal", "warp"])
def test_tail_pair_frames_matches_jax(pair_mode, tmp_path):
    frames = _frames(30, 3)
    path = str(tmp_path / "s.npy")
    records.FrameStore.write(path, frames, records.episode_pairs([30], 2))
    a, b, idx = records.tail_pair_frames(records.FrameStore(path), pair_mode,
                                         7, "cpu")
    ja, jb, jidx = jrecords.tail_pair_frames(jrecords.FrameStore(path),
                                             pair_mode, 7)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(idx, jidx)
    assert a.dtype == torch.float32 and a.shape == (7, 3, 16, 16)


def test_generate_face_store_equals_jax_byte_for_byte(tmp_path):
    faces.generate_face_store(str(tmp_path / "p.npy"), count=16, size=32,
                              seed=5, chunk=6)
    jfaces.generate_face_store(str(tmp_path / "j.npy"), count=16, size=32,
                               seed=5, chunk=6)
    assert ((tmp_path / "p.npy").read_bytes()
            == (tmp_path / "j.npy").read_bytes())
    assert (json.loads((tmp_path / "p_meta.json").read_text())
            == json.loads((tmp_path / "j_meta.json").read_text())
            == {"origin": "synthetic_faces", "seed": 5})
    assert not (tmp_path / "p_pairs.npy").exists()


def _assert_quantized_close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff > 0) <= QUANT_SHARE, np.mean(diff > 0)


def test_collect_scripted_pong_physics_and_frames_match_jax(monkeypatch):
    """The host physics is JAX's numpy to the bit (the trajectories JAX
    hands its renderer, caught at run time); the frames within one level."""
    seen = []
    render = jsynthetic._render_pong

    def catching(balls, pads, size):
        jax.debug.callback(lambda b, p: seen.append(
            (np.asarray(b), np.asarray(p))), balls, pads)
        return render(balls, pads, size)
    monkeypatch.setattr(jsynthetic, "_render_pong", catching)
    want, want_len = jcollect.collect_scripted_pong(2, 6, 32, seed=4)
    monkeypatch.setattr(jsynthetic, "_render_pong", render)
    got, got_len = collect.collect_scripted_pong(2, 6, 32, seed=4,
                                                 device="cpu")
    assert got_len == want_len == [6, 6]
    rng = np.random.RandomState(4)
    for balls_j, pads_j in seen:
        balls, pads = collect.pong_trajectory(6, rng)
        np.testing.assert_array_equal(balls, balls_j)
        np.testing.assert_array_equal(pads, pads_j)
    assert len(seen) == 2
    _assert_quantized_close(got, want)


def test_collect_writes_the_jax_store(tmp_path):
    collect.collect(str(tmp_path / "p"), env_name=None, episodes=2,
                    steps_per_episode=5, size=16, delta=2, seed=1,
                    device="cpu")
    jcollect.collect(str(tmp_path / "j"), env_name=None, episodes=2,
                     steps_per_episode=5, size=16, delta=2, seed=1)
    p, j = (records.FrameStore(str(tmp_path / n)) for n in "pj")
    _assert_quantized_close(np.asarray(p.frames), np.asarray(j.frames))
    np.testing.assert_array_equal(p.pairs, j.pairs)
    assert p.meta == j.meta == {"origin": "scripted_pong", "seed": 1}


def test_collect_cli_on_cpu(tmp_path, capsys):
    collect._cli(["--out", str(tmp_path / "c"), "--env", "none",
                  "--episodes", "2", "--steps-per-episode", "4", "--size",
                  "16", "--device", "cpu"])
    assert "8 frames" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            collect._cli(["--out", str(tmp_path / "d"), "--env", "none"])


def test_generate_pose_store_matches_jax(tmp_path):
    pose.generate_pose_store(str(tmp_path / "p"), episodes=2,
                             steps_per_episode=4, size=32, seed=2,
                             device="cpu")
    jpose.generate_pose_store(str(tmp_path / "j"), episodes=2,
                              steps_per_episode=4, size=32, seed=2)
    p, j = (records.FrameStore(str(tmp_path / n)) for n in "pj")
    _assert_quantized_close(np.asarray(p.frames), np.asarray(j.frames))
    np.testing.assert_array_equal(p.pairs, j.pairs)
    assert p.meta == j.meta == {"origin": "synthetic_pose", "seed": 2}


# --- the streams' contract ----------------------------------------------------

def _stream_store(tmp_path, n=23):
    frames = np.arange(n, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 1, 2, 2), np.uint8)
    path = str(tmp_path / "s.npy")
    records.FrameStore.write(path, frames, records.episode_pairs([n], 1))
    return records.FrameStore(path)


def _ids(batch):
    return (batch[..., 0, 0, 0] * 255).round().long().tolist()


@pytest.mark.parametrize("kind", ["single", "pair"])
def test_stream_batches_are_a_function_of_seed_and_index(kind, tmp_path):
    store = _stream_store(tmp_path)
    stream = records.single_stream if kind == "single" else records.pair_stream

    def take(start, k, workers=1, seed=3):
        it = stream(store, 5, seed, start_batch=start, workers=workers,
                    limit=19, device="cpu")
        out = []
        for _ in range(k):
            b = next(it)
            out.append(_ids(b) if kind == "single" else
                       [_ids(b[0]), _ids(b[1])])
        it.close()
        return out

    serial = take(0, 12)
    assert take(7, 5) == serial[7:]                       # O(1) resume
    assert take(0, 12, workers=4) == serial               # threaded order
    assert take(0, 12, seed=4) != serial
    rows = np.asarray([r if kind == "single" else r[0] for r in serial])
    flat = rows.ravel()
    # every epoch of 19 items is a permutation of [0, limit): the tail
    # (frames / pairs 19..22) is never drawn
    for e in range(len(flat) // 19):
        assert sorted(flat[e * 19:(e + 1) * 19]) == list(range(19))
    assert flat.max() < 19
    if kind == "pair":
        assert all(t == [s + 1 for s in src] for src, t in serial)


def test_stream_shards_partition_the_range(tmp_path):
    store = _stream_store(tmp_path, 20)
    seen = []
    for shard in range(3):
        it = records.single_stream(store, 7, 0, shard_index=shard,
                                   shard_count=3, limit=18, device="cpu")
        ids = _ids(next(it))[:6]
        it.close()
        assert all(i % 3 == shard for i in ids)
        seen += ids
    assert sorted(seen) == list(range(18))


def test_prefetch_keeps_order_and_drains():
    assert list(records.prefetch(iter(range(7)), depth=3)) == list(range(7))


# --- device-resident sampling -------------------------------------------------

def test_device_dataset_samples_within_limit(tmp_path):
    store = _stream_store(tmp_path)
    ds = device.DeviceDataset(store, device="cpu")
    assert ds.frames.dtype == torch.uint8 and ds.num_frames == 23
    gen = torch.Generator().manual_seed(0)
    f = device.sample_frames(ds.frames, gen, 64, limit=5)
    assert f.dtype == torch.float32 and max(_ids(f)) < 5
    a, b = device.sample_pair_frames(ds.frames, ds.pairs, gen, 64, limit=9)
    assert max(_ids(a)) < 9 and _ids(b) == [i + 1 for i in _ids(a)]
    g1 = torch.Generator().manual_seed(2)
    g2 = torch.Generator().manual_seed(2)
    assert torch.equal(ds.sample(g1, 8), ds.sample(g2, 8))
    assert ds.sample_pair(g1, 3)[0].shape == (3, 1, 2, 2)


def test_device_dataset_rejects_oversized(tmp_path):
    store = _stream_store(tmp_path)
    assert device.fits_in_memory(store, budget_bytes=store.frames.nbytes)
    with pytest.raises(ValueError, match="over the"):
        device.DeviceDataset(store, budget_bytes=store.frames.nbytes - 1,
                             device="cpu")


def test_device_memory_budget_falls_back_without_cuda(monkeypatch):
    assert device.device_memory_budget(device="cpu") == \
        device.DEFAULT_BUDGET_BYTES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.device_memory_budget() == device.DEFAULT_BUDGET_BYTES
    assert device.HEADROOM_BYTES == 3 << 30


def test_crash_hint_messages_match_jax():
    cfg, jcfg = get_config("pong64"), jax_get_config("pong64")
    for step, saved in ((70, None), (1234, 1000)):
        assert ptrain._crash_hint(step, saved, cfg) == jtrain._crash_hint(
            step, saved, jcfg)
    assert "No checkpoint has been written yet" in ptrain._crash_hint(
        70, None, cfg)
