"""Exported keypoint extractors — port of ``keypoints_tpu/export.py``.

The deployment unit of the extract path: ``Ψ → soft-argmax``, with the
trained parameters inside, traced by ``torch.export`` and saved as a
``.pt2`` file, or as a bundle of them, one per batch bucket. Loading one
builds no model and reads no checkpoint.

    # export (trainer side): a bundle of buckets 1, 8, 64 and 256
    python -m keypoints_tpu_torch.export --preset celeba128 \
        --checkpoint kp.pt --batch 1 8 64 256 --out extract.zip

    # serve (consumer side)
    from keypoints_tpu_torch.export import load_extract
    extract = load_extract("extract.zip")
    kp = extract(images)            # (n, C, H, W) numpy -> (n, K, 2) numpy

* :func:`export_extract` (``export.py:36``) traces one batch size,
  :func:`export_extract_bundle` (``:120``) several: a zip of ``b{N}.pt2``
  and ``meta.json`` with the JAX bundle's keys.
* :func:`load_extract` (``:91``) and :func:`load_extract_bundle` (``:214``)
  → a :class:`BucketedExtract`, which pads each request to the smallest
  covering bucket, splits oversize requests into max-bucket chunks and
  coerces uint8/float32 inputs (``:153-211``). Both formats are zips, so a
  bundle is told from a single ``.pt2`` by its top-level ``meta.json``.
* On CUDA each bucket's program is replayed from one CUDA graph
  (:class:`GraphedBucket`), as JAX's artifact is one compiled program a
  bucket; the live extract (``parallel.dp.make_dp_extract``) takes the
  same class. On the CPU a bucket runs eagerly.
* ``python -m keypoints_tpu_torch.export`` (``_cli``, ``:235``).

On CUDA the exported graph holds the soft-argmax kernel K1 as one node of
the custom op ``keypoints_tpu_torch::spatial_softmax_fwd``
(``kernels/spatial_softmax_cuda.py``); a CPU export holds the plain ops.
So loading an artifact needs ``keypoints_tpu_torch`` importable, which
registers the op (this module imports it); the JAX package's StableHLO
artifact needs jaxlib alone. AOTInductor is not used: its C++ runtime
cannot call an op implemented in Python through ``ctypes``.

An artifact's parameters live on the device it was exported on
(``--device``, default the card). It runs there only: loading it for
another device, or a CUDA artifact where no card is visible, raises. It is
never moved and never runs on the CPU in place of the card. JAX's
``--platforms`` (a multi-platform artifact) is not ported: it exists only
through ``kernels.xla_only``, a TPU-only workaround.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import time
import warnings
import zipfile
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from keypoints_tpu_torch.configs import Config
from keypoints_tpu_torch.training import CaptureError
from keypoints_tpu_torch.utils.profiling import span
# registers keypoints_tpu_torch::spatial_softmax_fwd, which CUDA artifacts call
from keypoints_tpu_torch.kernels import spatial_softmax_cuda  # noqa: F401

#: the input dtypes an artifact takes
INPUT_DTYPES = ("float32", "uint8")
_TORCH_DTYPES = {"float32": torch.float32, "uint8": torch.uint8}


class BucketedExtract:
    """Serve any batch size from per-bucket extract functions.

    A request of n images (a host numpy array) runs on the smallest bucket
    ≥ n: the batch is zero-padded up on the host, before the one upload
    (rows are independent through Ψ+soft-argmax, so padding never perturbs
    real outputs), and the result sliced back to n. Requests larger than the
    largest bucket are split into max-bucket chunks. Under a profiler a
    request is the span ``kp.extract.call`` (``utils.profiling.span``).
    """

    def __init__(self, fns: dict[int, Callable], meta: dict):
        self._fns = dict(sorted(fns.items()))
        self.meta = meta
        self.max_batch = max(self._fns)

    def coerce(self, images: np.ndarray) -> np.ndarray:
        """Convert a request to the extractor's input dtype (see meta).

        uint8 extractor + float request: quantize round(clip(x,0,1)·255) — the
        1/255-lossy path for float sources; uint8 sources pass through
        unchanged (and a float32 extractor fed uint8 rescales /255, lossless).
        """
        want = np.dtype(self.meta.get("input_dtype", "float32"))
        have = images.dtype
        if have == want:
            return images
        if want == np.uint8:
            return np.clip(np.round(images.astype(np.float32) * 255.0),
                           0, 255).astype(np.uint8)
        return images.astype(np.float32) / (255.0 if have == np.uint8
                                            else 1.0)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        with span("kp.extract.call"):
            return self._call(self.coerce(images))

    def _call(self, images: np.ndarray) -> np.ndarray:
        n = images.shape[0]
        bucket = next((b for b in self._fns if b >= n), None)
        if bucket is None:
            return np.concatenate([self._call(images[i:i + self.max_batch])
                                   for i in range(0, n, self.max_batch)])
        if n < bucket:
            images = np.concatenate(
                [images, np.zeros((bucket - n,) + images.shape[1:],
                                  images.dtype)])
        return self._fns[bucket](images)[:n]


def read_back(outputs: Sequence[torch.Tensor]) -> np.ndarray:
    """Wait for and read back a bucket's keypoints (one tensor a device,
    in row order) → one numpy array."""
    with span("kp.extract.read"):
        return np.concatenate([kp.cpu().numpy() for kp in outputs])


class GraphedBucket:
    """One bucket of a serving path replayed from one CUDA graph: numpy
    images of exactly ``(batch, *item_shape)`` and ``dtype`` → numpy
    keypoints, computed as ``run`` (device images → device keypoints, a
    uint8 rescale included) computes them.

    The first call runs ``run`` eagerly on its input (that builds the
    kernels' library and cuDNN's plans) and answers with that result, then
    captures ``run`` on a side stream, reading a static input on the card,
    into the device's memory pool in ``pools`` (device → a
    ``torch.cuda.graph_pool_handle()``, made at the device's first capture
    and shared by the buckets of one extractor, whose replays never
    overlap). Every later call uploads the images
    into the static input straight from the array (the driver stages a
    pageable copy in pipelined chunks; copying the batch into a pinned
    buffer first costs the host a whole extra pass over it), replays the
    graph and reads its output back. :meth:`enqueue` stops before the
    read, so several devices' slabs are all queued before the first is
    read. ``run`` runs under ``inference_mode`` (or ``no_grad``)
    of its own, inside the capture as on an eager call. A failed capture
    raises :class:`~keypoints_tpu_torch.training.CaptureError`, then and
    at every later call: nothing runs eagerly in its place. Under a
    profiler a replayed call's upload and replay are the spans
    ``kp.extract.upload`` and ``kp.extract.replay``
    (``utils.profiling.span``), and :func:`read_back` is
    ``kp.extract.read``.
    """

    def __init__(self, run: Callable, batch: int, item_shape: Sequence[int],
                 dtype: str, device: torch.device | str, pools: dict):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got "
                             f"{self.device}")
        self.run = run
        self.shape = (int(batch), *map(int, item_shape))
        self.dtype = np.dtype(dtype)
        self.pools = pools
        self.input: torch.Tensor | None = None    # the graph's, on the card
        self.output: torch.Tensor | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.failure: CaptureError | None = None
        #: host seconds of the capture, and the bytes it reserved
        self.capture_seconds: float | None = None
        self.pool_bytes: int | None = None

    def enqueue(self, images: np.ndarray) -> torch.Tensor:
        """Upload ``images`` and queue the bucket's work: → its keypoints on
        the card (the graph's output: read it before the next call)."""
        if images.shape != self.shape or images.dtype != self.dtype:
            raise ValueError(f"this bucket takes {self.shape} {self.dtype}, "
                             f"got {images.shape} {images.dtype}")
        if self.failure is not None:
            raise self.failure
        if self.graph is None:
            return self._first(images)
        with torch.cuda.device(self.device):
            with span("kp.extract.upload"):
                self.input.copy_(torch.from_numpy(images), non_blocking=True)
            with span("kp.extract.replay"):
                self.graph.replay()
        return self.output

    def __call__(self, images: np.ndarray) -> np.ndarray:
        return read_back([self.enqueue(images)])

    def _first(self, images: np.ndarray) -> torch.Tensor:
        """The eager call, then the capture."""
        device = self.device
        self.input = torch.from_numpy(images).to(device)
        answer = self.run(self.input)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        if device not in self.pools:
            self.pools[device] = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pools[device],
                                  stream=stream,
                                  capture_error_mode="thread_local"):
                self.output = self.run(self.input)
        except RuntimeError as e:
            self.failure = CaptureError(
                f"the CUDA graph capture of bucket {self.shape[0]} on "
                f"{device} failed: {e}")
            raise self.failure from e
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.graph = graph
        return answer


def bundle_meta(cfg: Config, batches: Sequence[int],
                input_dtype: str) -> dict:
    """The JAX bundle's ``meta.json``: shapes, buckets, K, input dtype."""
    d = cfg.data
    return {"format": "keypoints-extract-bundle", "version": 1,
            "batches": sorted({int(b) for b in batches}),
            "image_size": d.image_size, "channels": d.channels,
            "num_keypoints": cfg.model.num_keypoints,
            "input_dtype": input_dtype}


class _Extract(nn.Module):
    """What an artifact runs: uint8 frames rescaled /255 (as the live
    extract does after its upload), then ``model.extract_keypoints``."""

    def __init__(self, model: nn.Module, uint8: bool):
        super().__init__()
        self.model = model
        self.uint8 = uint8

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.uint8:
            images = images.float() / 255.0
        return self.model.extract_keypoints(images)


def _extractor(cfg: Config, state_dict: dict | None,
               device: torch.device | str, input_dtype: str) -> _Extract:
    """The serving model on ``device`` (``state_dict`` as
    ``checkpoint.load_model_state`` takes it, None keeps the seeded init),
    frozen for inference, with Φ and the decoder dropped: extraction never
    runs them, and an exported program keeps every parameter it is given."""
    from keypoints_tpu_torch.checkpoint import load_model_state
    from keypoints_tpu_torch.training import (build_model,
                                              freeze_for_inference)

    if input_dtype not in INPUT_DTYPES:
        raise ValueError(f"input_dtype must be float32|uint8, "
                         f"got {input_dtype!r}")
    model = build_model(cfg, device)
    if state_dict is not None:
        load_model_state(model, state_dict)
    model.encoder = model.decoder = None
    return _Extract(freeze_for_inference(model), input_dtype == "uint8")


def _export(extractor: _Extract, cfg: Config, batch: int,
            input_dtype: str) -> bytes:
    """Trace ``extractor`` at ``batch`` → the saved ``.pt2`` bytes, with
    ``meta.json`` and the parameters' device among its extra files."""
    d = cfg.data
    device = next(extractor.parameters()).device
    example = torch.zeros((batch, d.channels, d.image_size, d.image_size),
                          dtype=_TORCH_DTYPES[input_dtype], device=device)
    with torch.no_grad():
        program = torch.export.export(extractor, (example,))
    program.example_inputs = None          # not a batch of zeros in the file
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={
        "meta.json": json.dumps(bundle_meta(cfg, [batch], input_dtype)),
        "device": str(device)})
    return buf.getvalue()


def export_extract(cfg: Config, state_dict: dict | None, batch: int,
                   device: torch.device | str = "cuda",
                   input_dtype: str = "float32") -> bytes:
    """→ a saved ``torch.export`` program of ``extract_keypoints`` at ``batch``.

    ``input_dtype="uint8"`` exports a program taking raw uint8 frames (0–255
    ↔ the [0, 1] float convention; the /255 rescale runs on the device), as
    the live ``--input-dtype uint8`` server does: a 4× smaller upload.
    """
    return _export(_extractor(cfg, state_dict, device, input_dtype), cfg,
                   int(batch), input_dtype)


def export_extract_bundle(cfg: Config, state_dict: dict | None,
                          batches: Sequence[int],
                          device: torch.device | str = "cuda",
                          input_dtype: str = "float32") -> bytes:
    """→ a multi-bucket bundle: a zip of ``b{N}.pt2`` (one program a bucket,
    traced from one model) and ``meta.json`` (shapes, buckets, K, input
    dtype: the JAX bundle's keys)."""
    sizes = sorted({int(b) for b in batches})
    if not sizes or sizes[0] < 1:
        raise ValueError(f"invalid bucket list {batches!r}")
    extractor = _extractor(cfg, state_dict, device, input_dtype)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for b in sizes:
            z.writestr(f"b{b}.pt2", _export(extractor, cfg, b, input_dtype))
        z.writestr("meta.json", json.dumps(bundle_meta(cfg, sizes,
                                                       input_dtype)))
    return buf.getvalue()


def _read(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            return f.read()
    return bytes(path_or_bytes)


def _extra(archive: zipfile.ZipFile, name: str) -> str:
    """The extra file ``name`` that :func:`_export` saved into a ``.pt2``."""
    found = [n for n in archive.namelist() if n.endswith(f"extra/{name}")]
    if not found:
        raise ValueError(f"not an artifact of keypoints_tpu_torch.export: "
                         f"no extra file {name!r}")
    return archive.read(found[0]).decode()


def _run_on(own: torch.device, device: torch.device | str | None
            ) -> torch.device:
    """Raise unless an artifact whose parameters are on ``own`` can run as
    asked: on ``device`` (None: its own), with a card when it is CUDA's."""
    if device is not None:
        want = torch.device(device)
        if want.type != own.type or (want.index is not None
                                     and own.index is not None
                                     and want.index != own.index):
            raise ValueError(
                f"the artifact's parameters are on {own}; it runs there "
                f"only, not on {want} (export it again with --device "
                f"{want})")
    if own.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the artifact was exported for {own}, and CUDA "
                           f"is not available to this torch "
                           f"({torch.__version__}); export a CPU artifact "
                           f"(--device cpu) to run on the CPU")
    return own


def _load_program(data: bytes, device: torch.device | str | None,
                  pools: dict) -> tuple[Callable, dict]:
    """One ``.pt2`` → (fn(numpy images) -> numpy keypoints, its meta): a
    :class:`GraphedBucket` on CUDA (``pools`` as it takes them), the
    program called eagerly on the CPU."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        own = _run_on(torch.device(_extra(z, "device")), device)
        meta = json.loads(_extra(z, "meta.json"))
    with warnings.catch_warnings():
        # the loader wraps the archive's immutable bytes with
        # torch.frombuffer; nothing writes to an artifact's parameters
        warnings.filterwarnings("ignore", "The given buffer is not writable")
        module = torch.export.load(io.BytesIO(data)).module()

    def run(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(images)

    if own.type == "cuda":
        size = meta["image_size"]
        return GraphedBucket(run, meta["batches"][0],
                             (meta["channels"], size, size),
                             meta["input_dtype"], own, pools), meta

    def fn(images: np.ndarray) -> np.ndarray:
        return run(torch.from_numpy(images)).numpy()
    return fn, meta


def is_bundle(data: bytes) -> bool:
    """True for an :func:`export_extract_bundle` zip, False for a single
    ``.pt2`` (also a zip, with no top-level ``meta.json``)."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        return "meta.json" in z.namelist()


def load_extract(path_or_bytes, device: torch.device | str | None = None
                 ) -> BucketedExtract:
    """A saved extractor (a path or its bytes) → a :class:`BucketedExtract`
    on the artifact's own device; ``device``, when given, must be that
    device. A bundle loads all its buckets; a single artifact is a
    one-bucket bundle with the meta it was saved with."""
    data = _read(path_or_bytes)
    if is_bundle(data):
        return load_extract_bundle(data, device)
    fn, meta = _load_program(data, device, {})
    return BucketedExtract({meta["batches"][0]: fn}, meta)


def load_extract_bundle(path_or_bytes,
                        device: torch.device | str | None = None
                        ) -> BucketedExtract:
    """An :func:`export_extract_bundle` zip → a :class:`BucketedExtract`."""
    fns, pools = {}, {}
    with zipfile.ZipFile(io.BytesIO(_read(path_or_bytes))) as z:
        meta = json.loads(z.read("meta.json"))
        for b in meta["batches"]:
            fns[int(b)], _ = _load_program(z.read(f"b{b}.pt2"), device,
                                           pools)
    return BucketedExtract(fns, meta)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="export the keypoint extractor with torch.export (the "
                    "PyTorch port)")
    p.add_argument("--preset", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="a .pt state dict or a trainer checkpoint directory "
                        "(its newest step); omit for seeded random-init "
                        "params (smoke exports)")
    p.add_argument("--batch", type=int, nargs="+", default=[256],
                   help="one size -> a single artifact; several -> a bucket "
                        "bundle (requests pad up to the smallest cover)")
    p.add_argument("--out", required=True)
    p.add_argument("--input-dtype", default="float32", choices=INPUT_DTYPES,
                   help="uint8: raw 0-255 frames in, /255 on the device -- "
                        "4x smaller serving ingest (lossless for uint8 "
                        "sources; float requests quantize to 1/255)")
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="device the artifact's parameters live on and its "
                        "program runs on; only an explicit --device cpu "
                        "exports for the CPU")
    return p


def _cli(argv=None) -> None:
    from keypoints_tpu_torch.checkpoint import load_checkpoint
    from keypoints_tpu_torch.configs import apply_overrides, get_config
    from keypoints_tpu_torch.training import require_device

    args = build_parser().parse_args(argv)
    device = require_device(args.device, "export")
    cfg = apply_overrides(get_config(args.preset), args.override)
    state_dict = None
    if args.checkpoint:
        state_dict = load_checkpoint(args.checkpoint)
        print(f"exporting params from {args.checkpoint}", flush=True)
    t0 = time.perf_counter()
    if len(args.batch) > 1:
        data = export_extract_bundle(cfg, state_dict, args.batch, device,
                                     args.input_dtype)
        kind = f"bundle, buckets {sorted(set(args.batch))}"
    else:
        data = export_extract(cfg, state_dict, args.batch[0], device,
                              args.input_dtype)
        kind = f"batch {args.batch[0]}"
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {len(data) / 1e6:.2f} MB artifact to {args.out} ({kind}, "
          f"{args.input_dtype} in, {cfg.data.image_size}px, {device}) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # sanity: reload and run one batch
    extract = load_extract(args.out)
    d = cfg.data
    kp = extract(np.zeros((min(args.batch), d.channels, d.image_size,
                           d.image_size), np.float32))
    print(f"reload OK: output {kp.shape}", flush=True)


if __name__ == "__main__":
    _cli()
