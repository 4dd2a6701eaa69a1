"""Keypoint-serving front end — port of ``keypoints_tpu/serve.py``.

The device wants large batches; clients send small requests at random
times. ``BatchingExtractor`` coalesces concurrent requests into one device
batch (bounded by ``max_batch`` and ``max_delay_ms``), runs the extractor
once, and scatters the result rows back to their callers. ``BatchingExtractor``,
``http_meta`` and ``http_extract`` are copied from the JAX package (numpy and
threading only; that module is reachable only through the jax-importing
package). The server runs ``parallel.dp.make_dp_extract`` over
``--devices`` cards (default: every visible card), each taking an equal
slab of every padded bucket; ``make_live_extract`` is its one-device case.

    # serve celeba128 on the GPU from a state dict (keypoints-convert export-torch)
    python -m keypoints_tpu_torch.serve --preset celeba128 --checkpoint kp.pt

    # client: POST a .npy of (n, C, H, W) float32 in [0, 1]
    curl -s -X POST --data-binary @imgs.npy localhost:8000/extract > kp.npy
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Sequence

import numpy as np
import torch

from keypoints_tpu_torch.checkpoint import load_checkpoint
from keypoints_tpu_torch.configs import Config, apply_overrides, get_config
from keypoints_tpu_torch.export import BucketedExtract
from keypoints_tpu_torch.parallel import multihost
from keypoints_tpu_torch.parallel.dp import make_dp_extract
from keypoints_tpu_torch.training import require_device


class BatchingExtractor:
    """Coalesce concurrent extract requests into device-sized batches.

    ``extract`` is any callable ``(n, C, H, W) → (n, K, 2)`` accepting
    every ``n ≤ max_batch`` (a ``BucketedExtract`` bundle, a jitted model
    fn, …). Requests wait at most ``max_delay_ms`` for co-travelers; a
    request larger than ``max_batch`` is rejected (split it client-side or
    export a larger bucket).
    """

    def __init__(self, extract: Callable, max_batch: int,
                 max_delay_ms: float = 5.0,
                 item_shape: tuple | None = None):
        self._extract = extract
        self.max_batch = int(max_batch)
        self._delay = max_delay_ms / 1e3
        self._item_shape = tuple(item_shape) if item_shape else None
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()    # orders submit() vs close()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, images: np.ndarray) -> Future:
        """Enqueue an (n, C, H, W) request → Future of (n, K, 2).

        Malformed requests fail their own future here, before batching —
        a bad request must never poison the co-travelers it would have
        been concatenated with.
        """
        fut: Future = Future()
        n = images.shape[0] if images.ndim else 0
        if images.ndim < 2 or not 1 <= n <= self.max_batch:
            fut.set_exception(ValueError(
                f"request batch {n} outside [1, {self.max_batch}] "
                f"(shape {tuple(images.shape)})"))
            return fut
        with self._lock:                 # no enqueue after the sentinel
            # Pin the item shape from the first request when the caller gave
            # none: without this, two concurrent requests with different
            # item shapes both pass validation and the batch-level
            # concatenate fails — poisoning the VALID co-batched request.
            if self._item_shape is None:
                self._item_shape = tuple(images.shape[1:])
            if tuple(images.shape[1:]) != self._item_shape:
                fut.set_exception(ValueError(
                    f"request item shape {tuple(images.shape[1:])} != "
                    f"expected {self._item_shape}"))
            elif self._closed:
                fut.set_exception(RuntimeError("extractor is closed"))
            else:
                self._q.put((images, fut))
        return fut

    def extract(self, images: np.ndarray) -> np.ndarray:
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(images).result()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join()

    def _run(self) -> None:
        carry = None                     # request that overflowed last batch
        while True:
            first = carry if carry is not None else self._q.get()
            carry = None
            if first is None:
                return
            batch = self._admit([], first)
            total = sum(b[0].shape[0] for b in batch)
            deadline = time.monotonic() + self._delay
            while total < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:
                    self._flush(batch)
                    return
                if total + item[0].shape[0] > self.max_batch:
                    carry = item         # doesn't fit: leads the next batch
                    break
                self._admit(batch, item)
                total = sum(b[0].shape[0] for b in batch)
            self._flush(batch)

    @staticmethod
    def _admit(batch: list, item) -> list:
        # Claim the future NOW: a PENDING future can still be cancel()ed by
        # its caller, and set_result on a cancelled future raises
        # InvalidStateError — which would strand every co-batched request.
        if item[1].set_running_or_notify_cancel():
            batch.append(item)
        return batch

    def _flush(self, batch) -> None:
        if not batch:                    # everything was cancelled
            return
        try:
            images = np.concatenate([b[0] for b in batch], axis=0)
            kp = np.asarray(self._extract(images))
        except Exception as e:           # fan the failure out to every caller
            for _, fut in batch:
                fut.set_exception(e)
            return
        row = 0
        for images_i, fut in batch:
            n = images_i.shape[0]
            fut.set_result(kp[row:row + n])
            row += n


def http_meta(url: str, timeout: float = 10.0) -> dict:
    """GET a ``keypoints-serve`` endpoint's metadata (buckets, shapes, K).

    Connection-level failures (refused/reset/DNS/socket timeout) raise
    ``RuntimeError`` — retryable, same contract as :func:`http_extract`.
    """
    import json
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read())
    except (urllib.error.URLError, TimeoutError) as e:
        raise RuntimeError(f"metadata fetch failed: {e}") from None


#: per-URL /meta cache: bundle metadata is immutable for a server's
#: lifetime, so one fetch per endpoint suffices (invalidated when a size
#: rejection suggests the server was relaunched with different buckets)
_META_CACHE: dict = {}


def http_extract(url: str, images: np.ndarray,
                 timeout: float = 60.0) -> np.ndarray:
    """Client for ``keypoints-serve``: images ``(n, C, H, W)`` → ``(n, K, 2)``.

    The stdlib-only counterpart of the curl example above. Requests larger
    than the server's biggest bucket are split client-side (the server's
    batcher rejects oversized requests by design — rows are independent, so
    chunking is exact). HTTP 400 raises ``ValueError`` with the server's
    message (malformed request); other statuses AND connection-level
    failures (refused/reset/timeout) raise ``RuntimeError`` (retryable).
    """
    import io
    import urllib.error
    import urllib.request

    # uint8 payloads pass through raw (a uint8 server ingests them
    # verbatim and a float32 server rescales /255 — both lossless, and the
    # wire/upload cost is 4x smaller); anything else normalizes to float32
    # and, when the endpoint is KNOWN to take uint8 (cached /meta — fetched
    # anyway for multi-row bucket limits; never fetched just for dtype, so
    # single-row requests still skip /meta), is quantized client-side so
    # the wire sees 1 byte/px either way. An unquantized float POST to a
    # uint8 server is still correct: the server coerces at decode.
    if images.dtype == np.uint8:
        images = np.ascontiguousarray(images)
    else:
        images = np.ascontiguousarray(images, np.float32)

    def _quantize_if_u8_endpoint(x: np.ndarray) -> np.ndarray:
        if (x.dtype != np.uint8
                and _META_CACHE.get(url, {}).get("input_dtype") == "uint8"):
            return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
        return x

    def _post(chunk: np.ndarray) -> np.ndarray:
        chunk = _quantize_if_u8_endpoint(chunk)
        buf = io.BytesIO()
        np.save(buf, chunk)
        req = urllib.request.Request(url.rstrip("/") + "/extract",
                                     data=buf.getvalue(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return np.load(io.BytesIO(r.read()), allow_pickle=False)
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            if e.code == 400:
                raise ValueError(f"server rejected request: {body}") from None
            raise RuntimeError(f"extraction failed (HTTP {e.code}): "
                               f"{body}") from None
        except (urllib.error.URLError, TimeoutError) as e:
            raise RuntimeError(f"extraction failed: {e}") from None

    # a single row fits every bucket (buckets are >= 1) — skip /meta entirely
    if images.shape[0] <= 1:
        return _post(images)
    # metadata is cached per endpoint: one GET on first use, not per call
    if url not in _META_CACHE:
        _META_CACHE[url] = http_meta(url, timeout=timeout)
    limit = int(_META_CACHE[url]["batches"][-1])
    try:
        if images.shape[0] <= limit:
            return _post(images)
        return np.concatenate([_post(images[i:i + limit])
                               for i in range(0, images.shape[0], limit)])
    except ValueError:
        # size rejection with a cached limit → the server may have been
        # relaunched with smaller buckets; refresh and retry once
        fresh = http_meta(url, timeout=timeout)
        if int(fresh["batches"][-1]) == limit:
            raise                        # not a stale-bucket problem
        _META_CACHE[url] = fresh
        limit = int(fresh["batches"][-1])
        return np.concatenate([_post(images[i:i + limit])
                               for i in range(0, images.shape[0], limit)])


def make_live_extract(cfg: Config, state_dict: dict | None,
                      batches: Sequence[int],
                      device: torch.device | str = "cuda",
                      input_dtype: str = "float32") -> BucketedExtract:
    """One-device live serving: → a ``BucketedExtract`` running on ``device``.

    ``parallel.dp.make_dp_extract`` over ``[device]``: the model is built on
    ``device`` and its parameters uploaded once (``state_dict`` as
    ``checkpoint.load_model_state`` takes it; None keeps the seeded random
    init), and the conv weights are cast to the compute dtype once
    (``training.freeze_for_inference``). Each bucket's function uploads the
    padded request host→device, rescales uint8 /255 on the device, runs Ψ
    and the soft-argmax, and returns the (n, K, 2) keypoints as a numpy
    array.
    """
    return make_dp_extract(cfg, state_dict, batches, [device], input_dtype)


def serving_devices(device: torch.device | str,
                    n: int | None = None) -> list[torch.device]:
    """The devices ``--device``/``--devices`` name: the first ``n`` cards
    (default: every visible card) for a bare ``cuda``; ``device`` alone for
    ``cpu`` or an explicit ``cuda:k``, where ``n`` may only be 1."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        if n not in (None, 1):
            raise SystemExit(f"--devices {n} takes the first {n} cards of "
                             f"--device cuda, not {device}")
        return [device]
    count = torch.cuda.device_count()
    n = count if n is None else n
    if not 1 <= n <= count:
        raise SystemExit(f"--devices {n}: {count} card(s) visible")
    return [torch.device("cuda", i) for i in range(n)]


def _dp_extract_from_args(args: argparse.Namespace) -> BucketedExtract:
    """Live data-parallel extract of ``args``' preset and checkpoint over
    its devices (``serving_devices``)."""
    cfg = apply_overrides(get_config(args.preset), args.override)
    if args.checkpoint:
        state_dict = load_checkpoint(args.checkpoint)
        print(f"serving params from {args.checkpoint}", flush=True)
    else:
        state_dict = None
        print("WARNING: no --checkpoint, serving random-init params",
              flush=True)
    devices = serving_devices(args.device, args.devices)
    print(f"data-parallel serving: {len(devices)} device(s)", flush=True)
    return make_dp_extract(cfg, state_dict, args.batch, devices,
                           input_dtype=args.input_dtype)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="HTTP keypoint-extraction server: live data-parallel "
                    "extract of a config preset over local devices (the "
                    "PyTorch port)")
    p.add_argument("--preset", required=True)
    p.add_argument("--checkpoint", default=None,
                   help=".pt state dict (keypoints-convert export-torch); "
                        "omit for seeded random-init smoke serving")
    p.add_argument("--batch", type=int, nargs="+", default=[256],
                   help="bucket sizes; requests pad up to the smallest "
                        "cover (each must divide by the device count)")
    p.add_argument("--devices", type=int, default=None,
                   help="serve on the first N cards of --device cuda "
                        "(default: all visible)")
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="how long a request waits for co-travelers")
    p.add_argument("--input-dtype", default="float32",
                   choices=("float32", "uint8"),
                   help="serve raw uint8 frames (/255 on device) -- 4x "
                        "smaller request payloads and H2D uploads")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every bucket once before accepting "
                        "traffic (the first request per bucket then pays "
                        "the kernel build and cuDNN set-up)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on; only an explicit "
                        "--device cpu runs on the CPU")
    return p


def make_server(args: argparse.Namespace):
    """Build the server of parsed ``args`` → ``(httpd, batcher)``, not yet serving.

    ``httpd.serve_forever()`` serves; the caller then calls
    ``httpd.shutdown()`` (from another thread), ``httpd.server_close()`` and
    ``batcher.close()``. ``--port 0`` binds a free port
    (``httpd.server_address[1]``).
    """
    require_device(args.device, "serve")
    extract = _dp_extract_from_args(args)
    max_batch, meta = extract.max_batch, extract.meta
    want_dtype = np.dtype(meta["input_dtype"])
    if not args.no_warmup:
        # run every bucket up front: the first launch builds the kernel
        # library and sets up cuDNN, which would stall the first request
        # (and everything queued behind it)
        for b in meta["batches"]:
            t0 = time.monotonic()
            extract(np.zeros((b, meta["channels"], meta["image_size"],
                              meta["image_size"]), want_dtype))
            print(f"warmed bucket b{b} in {time.monotonic() - t0:.1f}s",
                  flush=True)
    batcher = BatchingExtractor(
        extract, max_batch, args.max_delay_ms,
        item_shape=(meta["channels"], meta["image_size"],
                    meta["image_size"]))

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(meta).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            try:
                try:            # a missing/garbage header is a CLIENT error
                    length = int(self.headers["Content-Length"])
                except (TypeError, ValueError):
                    raise ValueError("missing or invalid Content-Length")
                raw = self.rfile.read(length)
                images = np.load(io.BytesIO(raw), allow_pickle=False)
                # coerce to the extractor's input dtype at DECODE — requests
                # of mixed dtypes must agree before the batcher
                # concatenates them
                images = extract.coerce(np.ascontiguousarray(images))
                kp = batcher.extract(images)
                out = io.BytesIO()
                np.save(out, np.asarray(kp))
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                self.wfile.write(out.getvalue())
            except ValueError as e:      # malformed request (shape/decode)
                self.send_response(400)
                self.end_headers()
                self.wfile.write(str(e).encode())
            except Exception as e:       # device/runtime fault — retryable
                self.send_response(503)
                self.end_headers()
                self.wfile.write(
                    f"extraction failed: {type(e).__name__}".encode())

        def log_message(self, *a):       # quiet access log
            pass

    try:
        httpd = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    except OSError:
        batcher.close()
        raise
    return httpd, batcher


def _cli(argv=None):
    args = build_parser().parse_args(argv)
    # torchrun's process group, if any (serving itself has no collective)
    multihost.initialize("gloo" if torch.device(args.device).type == "cpu"
                         else None)
    httpd, batcher = make_server(args)
    print(f"serving --preset {args.preset} on {args.device} at "
          f":{httpd.server_address[1]} (buckets {sorted(set(args.batch))})",
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        batcher.close()


if __name__ == "__main__":
    _cli()
