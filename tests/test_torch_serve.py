"""The port's serving layer and the whole serving slice on the CPU.

The batcher cases mirror tests/test_serve.py; the slice test runs the port's
HTTP server (``make_server`` with ``--device cpu``) and holds its answers to
the JAX package's ``make_extract_fn`` on the same params. The ``cuda``
tests hold each bucket's CUDA graph (``export.GraphedBucket``) to the eager
extract bit for bit; they skip here and run on the card with
``--noconftest``, where there is no JAX, so the JAX package is imported
inside the tests that compare with it.
"""

import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import apply_overrides, get_config
from keypoints_tpu_torch.export import BucketedExtract, GraphedBucket
from keypoints_tpu_torch.kernels import spatial_softmax_cuda as ssc
from keypoints_tpu_torch.parallel import dp as dp_mod
from keypoints_tpu_torch.serve import (BatchingExtractor, build_parser,
                                       http_extract, http_meta,
                                       make_live_extract, make_server)
from keypoints_tpu_torch.testing import random_flax_params, share_cpu_threads
from keypoints_tpu_torch.training import (CaptureError, build_model,
                                          freeze_for_inference,
                                          make_extract_fn)

share_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]
NARROW = ["model.encoder_filters=(8,16)", "model.encoder_strides=(2,2)",
          "model.groups=4", "model.num_keypoints=4", "data.image_size=32",
          "train.compute_dtype=float32"]


def _row_id_extract(images):
    """Fake extractor whose output identifies each input row."""
    flat = np.asarray(images).reshape(images.shape[0], -1)
    return np.stack([flat[:, 0], flat[:, 1]], axis=1)[:, None, :]  # (n,1,2)


def test_batching_extractor_routes_rows_exactly():
    calls = []

    def extract(images):
        calls.append(images.shape[0])
        assert images.shape[0] <= 4, "batch exceeded max_batch"
        return _row_id_extract(images)

    srv = BatchingExtractor(extract, max_batch=4, max_delay_ms=20)
    rs = np.random.RandomState(0)
    reqs = [rs.rand(n, 1, 2, 2).astype(np.float32)
            for n in (1, 3, 2, 1, 4, 2)]
    futs = [srv.submit(r) for r in reqs]
    for req, fut in zip(reqs, futs):
        got = fut.result(timeout=10)
        np.testing.assert_array_equal(got, _row_id_extract(req))
        assert got.shape == (req.shape[0], 1, 2)
    srv.close()
    assert sum(calls) == sum(r.shape[0] for r in reqs)


def test_batching_extractor_concurrent_threads():
    srv = BatchingExtractor(_row_id_extract, max_batch=8, max_delay_ms=10)
    rs = np.random.RandomState(1)
    reqs = [rs.rand(1 + i % 3, 1, 2, 2).astype(np.float32)
            for i in range(20)]
    results = [None] * len(reqs)

    def worker(i):
        results[i] = srv.extract(reqs[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    srv.close()
    for req, got in zip(reqs, results):
        np.testing.assert_array_equal(got, _row_id_extract(req))


def test_batching_extractor_rejects_oversize_shape_and_closed():
    srv = BatchingExtractor(_row_id_extract, max_batch=2, max_delay_ms=1,
                            item_shape=(1, 2, 2))
    with pytest.raises(ValueError, match="outside"):
        srv.submit(np.zeros((3, 1, 2, 2), np.float32)).result(timeout=10)
    with pytest.raises(ValueError, match="item shape"):
        srv.submit(np.zeros((1, 1, 4, 4), np.float32)).result(timeout=10)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.zeros((1, 1, 2, 2), np.float32)).result(timeout=10)


def test_batching_extractor_fans_out_failures():
    def broken(images):
        raise RuntimeError("device on fire")

    srv = BatchingExtractor(broken, max_batch=4, max_delay_ms=1)
    futs = [srv.submit(np.zeros((1, 1, 2, 2), np.float32)) for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=10)
    srv.close()


def _recording_bundle(batches=(1, 4), input_dtype="float32"):
    seen = []

    def fn(images):
        seen.append((images.shape[0], images.dtype))
        return _row_id_extract(images)

    meta = {"batches": list(batches), "input_dtype": input_dtype}
    return BucketedExtract({b: fn for b in batches}, meta), seen


def test_bucketed_extract_pads_and_splits():
    ext, seen = _recording_bundle()
    rs = np.random.RandomState(2)
    for n in (1, 2, 3, 4, 9):          # 2, 3 pad to b4; 9 splits 4 + 4 + 1
        images = rs.rand(n, 1, 2, 2).astype(np.float32)
        np.testing.assert_array_equal(ext(images), _row_id_extract(images))
    assert [s for s, _ in seen] == [1, 4, 4, 4, 4, 4, 1]


def test_bucketed_extract_coerces_dtypes():
    u8 = np.array([[[[0, 51], [255, 128]]]], np.uint8)
    f32_ext, _ = _recording_bundle(input_dtype="float32")
    got = f32_ext.coerce(u8)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, u8 / 255.0, atol=1e-7)
    f32 = u8 / np.float32(255)
    assert f32_ext.coerce(f32) is f32

    u8_ext, seen = _recording_bundle(input_dtype="uint8")
    f = np.array([[[[-0.5, 0.2], [1.5, 0.5]]]], np.float32)
    got = u8_ext.coerce(f)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, [[[[0, 51], [255, 128]]]])
    assert u8_ext.coerce(u8) is u8
    u8_ext(f)                          # the extract fn sees uint8 frames
    assert seen == [(1, np.uint8)]


@pytest.fixture(scope="module")
def cpu_server(tmp_path_factory):
    """The port's HTTP server on the CPU: narrow celeba128 in f32, seeded
    params from a .pt state dict, buckets 1 and 4, on a free port."""
    cfg = apply_overrides(get_config("celeba128"), NARROW)
    params = random_flax_params(cfg, 0)
    ckpt = tmp_path_factory.mktemp("serve") / "kp.pt"
    torch.save({k: torch.from_numpy(v)
                for k, v in state_dict_from_flax(params).items()}, str(ckpt))
    args = build_parser().parse_args(
        ["--preset", "celeba128", "--checkpoint", str(ckpt), "--device",
         "cpu", "--port", "0", "--batch", "1", "4", "--max-delay-ms", "1",
         "--override", *NARROW])
    httpd, batcher = make_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://localhost:{httpd.server_address[1]}", params
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=10)


def test_serving_slice_matches_jax(cpu_server):
    import jax
    import jax.numpy as jnp
    from keypoints_tpu.configs import apply_overrides as jax_apply_overrides
    from keypoints_tpu.configs import get_config as jax_get_config
    from keypoints_tpu.training import build_model as jax_build_model
    from keypoints_tpu.training import make_extract_fn as jax_make_extract_fn
    url, params = cpu_server
    jcfg = jax_apply_overrides(jax_get_config("celeba128"), NARROW)
    jax_extract = jax.jit(jax_make_extract_fn(jcfg, jax_build_model(jcfg)))
    rs = np.random.RandomState(3)
    for n in (1, 3, 6):                      # 6 > max bucket: client splits
        images = rs.rand(n, 3, 32, 32).astype(np.float32)
        got = http_extract(url, images)
        assert got.shape == (n, 4, 2)
        np.testing.assert_allclose(
            got, np.asarray(jax_extract(params, jnp.asarray(images))),
            rtol=0, atol=1e-4)
    frames = rs.randint(0, 256, (2, 3, 32, 32)).astype(np.uint8)
    want = jax_extract(params, jnp.asarray(frames, jnp.float32) / 255.0)
    np.testing.assert_allclose(http_extract(url, frames), np.asarray(want),
                               rtol=0, atol=1e-4)


def test_serving_meta_has_the_jax_servers_keys(cpu_server):
    import jax
    from keypoints_tpu.configs import get_config as jax_get_config
    from keypoints_tpu.parallel.dp import data_parallel_mesh, make_dp_extract
    url, params = cpu_server
    meta = http_meta(url)
    jcfg = jax_get_config("celeba128").override(**{
        "model.num_keypoints": 4, "data.image_size": 32})
    jax_meta = make_dp_extract(jcfg, params, [1, 4],
                               data_parallel_mesh(jax.devices()[:1]),
                               input_dtype="float32").meta
    assert meta == jax_meta
    with pytest.raises(ValueError, match="rejected"):
        http_extract(url, np.zeros((2, 3, 8, 8), np.float32))


def test_uint8_live_extract_rescales_on_device():
    """--input-dtype uint8: frames go up as bytes and /255 runs after the
    upload; the keypoints equal the float32 extractor's on frames/255."""
    cfg = apply_overrides(get_config("celeba128"), NARROW)
    state = state_dict_from_flax(random_flax_params(cfg, 0))
    frames = np.random.RandomState(4).randint(
        0, 256, (3, 3, 32, 32)).astype(np.uint8)
    u8 = make_live_extract(cfg, state, [4], "cpu", input_dtype="uint8")
    f32 = make_live_extract(cfg, state, [4], "cpu")
    assert u8.meta["input_dtype"] == "uint8"
    np.testing.assert_allclose(u8(frames),
                               f32(frames.astype(np.float32) / 255.0),
                               rtol=0, atol=1e-6)


def test_cuda_device_without_cuda_exits_with_message():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here, so --device cuda would serve")
    args = build_parser().parse_args(["--preset", "celeba128"])
    assert args.device == "cuda"
    with pytest.raises(SystemExit, match="--device cpu"):
        make_server(args)


def test_cuda_wrapper_raises_on_cpu_tensor():
    before = ssc.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssc.spatial_softmax_cuda(torch.zeros((1, 2, 8, 8)))
    assert ssc.launches == before


def test_port_imports_no_jax():
    code = ("import sys, keypoints_tpu_torch, keypoints_tpu_torch.serve, "
            "keypoints_tpu_torch.kernels, keypoints_tpu_torch.training, "
            "keypoints_tpu_torch.checkpoint, keypoints_tpu_torch.testing, "
            "keypoints_tpu_torch.models.vgg, keypoints_tpu_torch.train, "
            "keypoints_tpu_torch.ops.pool, "
            "keypoints_tpu_torch.kernels.pool_cuda, "
            "keypoints_tpu_torch.models.transporter, "
            "keypoints_tpu_torch.data.synthetic, "
            "keypoints_tpu_torch.ops.fused_bottleneck, "
            "keypoints_tpu_torch.kernels.fused_bottleneck_cuda, "
            "keypoints_tpu_torch.ops.experimental, "
            "keypoints_tpu_torch.kernels.experimental, "
            "keypoints_tpu_torch.kernels.experimental_cuda, "
            "keypoints_tpu_torch.eval, keypoints_tpu_torch.data.faces, "
            "keypoints_tpu_torch.data.pose, keypoints_tpu_torch.viz, "
            "keypoints_tpu_torch.data.records, "
            "keypoints_tpu_torch.data.device, "
            "keypoints_tpu_torch.data.collect, keypoints_tpu_torch.parallel, "
            "keypoints_tpu_torch.parallel.dp, "
            "keypoints_tpu_torch.parallel.multihost, "
            "keypoints_tpu_torch.export, keypoints_tpu_torch.video, "
            "keypoints_tpu_torch.utils, keypoints_tpu_torch.utils.debug, "
            "keypoints_tpu_torch.utils.profiling; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'keypoints_tpu.')) or m == 'keypoints_tpu');"
            " assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|keypoints_tpu)\b(?!_torch)",
                         re.M)
    for path in [*ROOT.joinpath("keypoints_tpu_torch").rglob("*.py"),
                 ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def _record_buckets(monkeypatch) -> list:
    """→ the list that every ``GraphedBucket`` the live extract makes from
    now on is appended to."""
    made = []

    class Recorded(GraphedBucket):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setattr(dp_mod, "GraphedBucket", Recorded)
    return made


def test_a_cpu_extract_runs_eagerly_and_a_graph_needs_the_card(monkeypatch):
    cfg = apply_overrides(get_config("celeba128"), NARROW)
    made = _record_buckets(monkeypatch)
    live = make_live_extract(cfg, None, [1, 4], "cpu")
    assert live(np.zeros((3, 3, 32, 32), np.float32)).shape == (3, 4, 2)
    assert made == []
    with pytest.raises(ValueError, match="CUDA device"):
        GraphedBucket(lambda x: x, 4, (3, 32, 32), "float32", "cpu", {})


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph runs only on the GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("input_dtype", ["float32", "uint8"])
def test_graphed_bucket_equals_the_eager_extract(cuda, input_dtype,
                                                 monkeypatch):
    """Buckets 1 and 4 of ``make_live_extract`` on the card: each bucket's
    first call answers eagerly and captures its graph; the replays that
    follow, on new images, equal the eager extract of the same model at
    the same bucket bit for bit (uint8 rescaled inside the graph)."""
    cfg = apply_overrides(get_config("celeba128"), NARROW)
    state = state_dict_from_flax(random_flax_params(cfg, 0))
    made = _record_buckets(monkeypatch)
    live = make_live_extract(cfg, state, [1, 4], cuda, input_dtype)
    model = build_model(cfg, cuda)
    load_model_state(model, state)
    extract = make_extract_fn(freeze_for_inference(model))

    def eager(images):
        x = torch.from_numpy(images).to(cuda)
        return extract(x.float() / 255.0 if x.dtype == torch.uint8
                       else x).cpu().numpy()

    rs = np.random.RandomState(7)
    for b in (1, 4):
        for call in range(3):
            x = rs.rand(b, 3, 32, 32).astype(np.float32)
            if input_dtype == "uint8":
                x = (x * 255).astype(np.uint8)
            assert np.array_equal(live(x), eager(x)), (b, call)
            graph, = [g for g in made if g.shape[0] == b]
            assert graph.graph is not None and graph.capture_seconds > 0


@pytest.mark.cuda
def test_failed_bucket_capture_raises_with_no_eager_answer(cuda):
    """A bucket whose function reads the card on the host cannot be
    captured: its first call raises ``CaptureError`` (the eager result it
    computed first is not returned), and so does every later call, which
    runs nothing."""
    calls = []

    def run(x):
        calls.append(x.shape)
        return x * float(x.sum())

    bucket = GraphedBucket(run, 2, (1, 4, 4), "float32", cuda, {})
    x = np.ones((2, 1, 4, 4), np.float32)
    with pytest.raises(CaptureError, match="bucket 2"):
        bucket(x)
    assert len(calls) == 2               # the eager call and the capture
    with pytest.raises(CaptureError):
        bucket(x)
    assert len(calls) == 2
