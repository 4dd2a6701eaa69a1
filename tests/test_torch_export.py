"""The port's artifact export and its consumers on the CPU, against JAX's.

The soft-argmax K1 as the ``torch.library`` op (``opcheck``), and a CUDA
trace of the extractor, made here on fake CUDA tensors, holding that op
once and none of the plain soft-argmax's ops; the port's CPU artifacts
(single and bundle, float32 and uint8 in) against the JAX package's
``export_extract`` / ``export_extract_bundle`` on the same params; bundle
detection, meta, the device guard; the export CLI, ``eval --artifact``
against JAX's record, and ``serve --artifact`` over HTTP. Every artifact is
exported once per module at narrow celeba128 widths in f32.
"""

import io
import json
import threading
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keypoints_tpu import eval as jeval
from keypoints_tpu import export as jexport
from keypoints_tpu.configs import get_config as jax_get_config
from keypoints_tpu_torch import eval as peval
from keypoints_tpu_torch import export
from keypoints_tpu_torch.checkpoint import state_dict_from_flax
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.kernels import spatial_softmax_cuda as ssc
from keypoints_tpu_torch.serve import build_parser, http_extract, make_server
from keypoints_tpu_torch.testing import random_flax_params, share_cpu_threads

share_cpu_threads()

# celeba128's structure at 32² with narrow filters, f32
NARROW = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
          "model.decoder_filters": (16, 8),
          "model.decoder_upsample": (True, True), "model.groups": 4,
          "model.num_keypoints": 4, "data.image_size": 32,
          "train.compute_dtype": "float32"}
ATOL = 1e-4          # as test_serving_slice_matches_jax: f32, sum order only
OP = "keypoints_tpu_torch.spatial_softmax_fwd.default"


def _args(overrides: dict) -> list:
    return [f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in overrides.items()]


@pytest.fixture(scope="module")
def artifacts():
    """Each kind of artifact of one set of params, from both packages:
    {(kind, input_dtype): (port bytes, JAX bytes)}, kind single (b4) or
    bundle (buckets 1 and 4)."""
    cfg = get_config("celeba128").override(**NARROW)
    jcfg = jax_get_config("celeba128").override(**NARROW)
    params = random_flax_params(cfg, 0)
    state = {k: torch.from_numpy(v)
             for k, v in state_dict_from_flax(params).items()}
    out = {}
    for dtype in export.INPUT_DTYPES:
        out["single", dtype] = (
            export.export_extract(cfg, state, 4, "cpu", dtype),
            jexport.export_extract(jcfg, params, 4, input_dtype=dtype))
        out["bundle", dtype] = (
            export.export_extract_bundle(cfg, state, [4, 1], "cpu", dtype),
            jexport.export_extract_bundle(jcfg, params, [4, 1],
                                          input_dtype=dtype))
    return out


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (1, 5, 7, 13)])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("variant", ["joint", "marginal"])
def test_k1_op_passes_opcheck(variant, align_corners, shape):
    x = torch.from_numpy(
        np.random.RandomState(0).randn(*shape).astype(np.float32))
    torch.library.opcheck(ssc.spatial_softmax_op,
                          (x, 0.7, variant, align_corners))
    got = ssc.spatial_softmax_op(x, 0.7, variant, align_corners)
    want = ssc._plain(x, 0.7, variant, align_corners)
    assert torch.equal(got, want)


def _fake_cuda(module: torch.nn.Module) -> None:
    """Replace every parameter by a fake CUDA tensor of its shape and dtype
    (call inside a FakeTensorMode)."""
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="cuda"),
                    requires_grad=False)


@pytest.mark.parametrize("preset,dtype", [("celeba128", "float32"),
                                          ("celeba128", "uint8"),
                                          ("transporter_atari", "float32")])
def test_cuda_trace_holds_k1_as_one_op_node(preset, dtype):
    """The extractor traced on (fake) CUDA tensors, as the card's export
    traces it: the soft-argmax is one node of the K1 op, and none of the
    plain soft-argmax's ops (softmax, its sums and coordinate grids) is
    left in the graph."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(preset).override(**{
        k: v for k, v in NARROW.items() if k != "train.compute_dtype"})
    extractor = export._extractor(cfg, None, "cpu", dtype)
    d = cfg.data
    with FakeTensorMode(allow_non_fake_inputs=True):
        _fake_cuda(extractor)
        x = torch.zeros((4, d.channels, d.image_size, d.image_size),
                        dtype=export._TORCH_DTYPES[dtype], device="cuda")
        with torch.no_grad():
            program = torch.export.export(extractor, (x,))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(OP) == 1
    plain = ("softmax", "arange", "sum", "stack", "repeat", "mul.")
    assert not [t for t in targets if t != OP and any(p in t for p in plain)]
    assert "aten.conv2d.default" in targets


def test_cpu_artifact_holds_the_plain_ops(artifacts):
    program = torch.export.load(io.BytesIO(artifacts["single", "float32"][0]))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert OP not in targets and "aten.softmax.int" in targets


@pytest.mark.parametrize("n", [1, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("kind", ["single", "bundle"])
def test_artifact_matches_jax(artifacts, kind, dtype, n):
    """n=1, n=3 (padded to b4) and n=6 (above the top bucket: split) on the
    port's artifact and on JAX's of the same params."""
    ours, theirs = artifacts[kind, dtype]
    got_fn, want_fn = export.load_extract(ours), jexport.load_extract(theirs)
    rs = np.random.RandomState(n)
    images = rs.rand(n, 3, 32, 32).astype(np.float32)
    if dtype == "uint8":
        images = (images * 255).astype(np.uint8)
    got = got_fn(images)
    assert got.shape == (n, 4, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want_fn(images)), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("source", ["bytes", "file"])
@pytest.mark.parametrize("kind", ["single", "bundle"])
def test_bundle_and_single_detection(artifacts, tmp_path, kind, source):
    data = artifacts[kind, "float32"][0]
    assert export.is_bundle(data) == (kind == "bundle")
    assert zipfile.is_zipfile(io.BytesIO(data))        # both formats: zips
    if source == "file":
        path = tmp_path / "a.bin"
        path.write_bytes(data)
        data = str(path)
    ext = export.load_extract(data)
    assert ext.meta["batches"] == ([1, 4] if kind == "bundle" else [4])
    assert ext.max_batch == 4


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("kind", ["single", "bundle"])
def test_meta_equals_jax(artifacts, kind, dtype):
    ours, theirs = artifacts[kind, dtype]
    meta = export.load_extract(ours).meta
    assert meta == jexport.load_extract(theirs).meta
    assert meta["input_dtype"] == dtype
    if kind == "bundle":
        with zipfile.ZipFile(io.BytesIO(ours)) as z, \
                zipfile.ZipFile(io.BytesIO(theirs)) as jz:
            assert (json.loads(z.read("meta.json"))
                    == json.loads(jz.read("meta.json")))
            assert sorted(z.namelist()) == ["b1.pt2", "b4.pt2", "meta.json"]


def _with_device(data: bytes, device: str) -> bytes:
    """A copy of a single artifact whose recorded device is ``device``."""
    buf = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(data)) as src, \
            zipfile.ZipFile(buf, "w") as dst:
        for item in src.infolist():
            body = src.read(item.filename)
            if item.filename.endswith("extra/device"):
                body = device.encode()
            dst.writestr(item, body)
    return buf.getvalue()


def test_an_artifact_runs_on_its_own_device_only(artifacts):
    data = artifacts["single", "float32"][0]
    assert export.load_extract(data, "cpu").meta["batches"] == [4]
    for device in ("cuda", "cuda:0", "meta"):
        with pytest.raises(ValueError, match="runs there only"):
            export.load_extract(data, device)
    with pytest.raises(ValueError, match="runs there only"):
        export.load_extract(artifacts["bundle", "float32"][0], "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export.load_extract(_with_device(data, "cuda:0"))
    with pytest.raises(ValueError, match="not an artifact"):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as z:
            z.writestr("x/y", b"")
        export.load_extract(buf.getvalue())


@pytest.mark.parametrize("batch", [["2"], ["1", "4"]])
def test_export_cli(tmp_path, capsys, batch):
    out = tmp_path / "e.pt2"
    export._cli(["--preset", "pong64", "--batch", *batch, "--out", str(out),
                 "--device", "cpu", "--input-dtype", "uint8", "--override",
                 *_args(NARROW)])
    printed = capsys.readouterr().out
    assert "wrote" in printed
    assert f"reload OK: output ({batch[0]}, 4, 2)" in printed
    ext = export.load_extract(str(out))
    assert ext.meta["batches"] == sorted(map(int, batch))
    assert ext.meta["input_dtype"] == "uint8"
    assert export.is_bundle(out.read_bytes()) == (len(batch) > 1)


def test_export_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here, so the default would export")
    with pytest.raises(SystemExit, match="--device cpu"):
        export._cli(["--preset", "pong64", "--out", str(tmp_path / "e.pt2")])


# transporter_atari's structure at 32² with narrow filters, f32, on a store
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


def test_eval_artifact_cli_record_matches_jax(tmp_path, capsys):
    """``eval --artifact`` of one set of params through each package's
    artifact and CLI, on the store's held-out tail (no randomness): the
    same record, the keypoint metrics within 1e-4, no eval_loss, step
    null; ``--overlay`` writes the PNG; a preset mismatch exits with
    JAX's message."""
    over = {**NARROW_ATARI, "data.data_dir": _atari_store(tmp_path)}
    cfg = get_config("transporter_atari").override(**over)
    jcfg = jax_get_config("transporter_atari").override(**over)
    params = random_flax_params(cfg, 0)
    ours, theirs = tmp_path / "p.pt2", tmp_path / "j.shlo"
    ours.write_bytes(export.export_extract(cfg, state_dict_from_flax(params),
                                           16, "cpu"))
    theirs.write_bytes(jexport.export_extract(jcfg, params, 16))
    common = ["--preset", "transporter_atari", "--override", *_args(over)]
    jeval._cli([*common, "--artifact", str(theirs), "--json",
                str(tmp_path / "j.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    png = tmp_path / "o.png"
    got = peval.main([*common, "--artifact", str(ours), "--device", "cpu",
                      "--overlay", str(png)])
    assert "overlay written" in capsys.readouterr().out
    assert got.keys() == want.keys() and got["step"] is None
    assert {k: v for k, v in got.items() if k != "metrics"} == {
        k: v for k, v in want.items() if k != "metrics"}
    assert set(got["metrics"]) == set(want["metrics"]) == {
        "keypoint_spread", "keypoint_in_bounds"}
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-4, k
    import cv2
    assert cv2.imread(str(png)).shape == (2 * 32, 4 * 32, 3)
    with pytest.raises(SystemExit, match="artifact/config mismatch"):
        peval.main([*common, "model.num_keypoints=5", "--artifact",
                    str(ours), "--device", "cpu"])
    with pytest.raises(SystemExit, match="exactly one"):
        peval.main(common + ["--device", "cpu"])


@pytest.fixture(scope="module")
def artifact_server(artifacts, tmp_path_factory):
    """``serve --artifact`` of the float32 bundle on the CPU, a free port."""
    path = tmp_path_factory.mktemp("serve") / "bundle.zip"
    path.write_bytes(artifacts["bundle", "float32"][0])
    args = build_parser().parse_args(
        ["--artifact", str(path), "--device", "cpu", "--port", "0",
         "--max-delay-ms", "1"])
    httpd, batcher = make_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://localhost:{httpd.server_address[1]}", str(path)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=10)
        assert not thread.is_alive()


@pytest.mark.parametrize("n", [1, 3, 6])
def test_serve_artifact_equals_the_in_process_artifact(artifact_server, n):
    url, path = artifact_server
    images = np.random.RandomState(20 + n).rand(n, 3, 32, 32).astype(
        np.float32)
    got = http_extract(url, images)
    assert np.array_equal(got, export.load_extract(path)(images))


def test_serve_takes_exactly_one_source(artifact_server):
    _, path = artifact_server
    cases = [("exactly one", ["--device", "cpu"]),
             ("exactly one", ["--artifact", path, "--preset", "celeba128",
                              "--device", "cpu"]),
             ("--devices applies", ["--artifact", path, "--devices", "1",
                                    "--device", "cpu"])]
    for match, argv in cases:
        with pytest.raises(SystemExit, match=match):
            make_server(build_parser().parse_args([*argv, "--port", "0"]))
    with pytest.raises(ValueError, match="runs there only"):
        make_server(build_parser().parse_args(
            ["--artifact", path, "--device", "meta", "--port", "0"]))


def test_jax_serving_agrees_with_the_port_artifact(artifact_server):
    """The whole slice: the port's HTTP answers against JAX's jitted
    extract of the same params, as ``test_serving_slice_matches_jax``."""
    from keypoints_tpu.training import build_model, make_extract_fn
    url, _ = artifact_server
    jcfg = jax_get_config("celeba128").override(**NARROW)
    jax_extract = jax.jit(make_extract_fn(jcfg, build_model(jcfg)))
    params = random_flax_params(get_config("celeba128").override(**NARROW), 0)
    images = np.random.RandomState(5).rand(5, 3, 32, 32).astype(np.float32)
    np.testing.assert_allclose(
        http_extract(url, images),
        np.asarray(jax_extract(params, jnp.asarray(images))), rtol=0,
        atol=ATOL)
