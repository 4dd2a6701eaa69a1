#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Drives the three ported paths of ``keypoints_tpu_torch`` at full width
through their user entry points, with weights made from a seed: celeba128's
keypoint-serving path (``make_server``) and training step (``init_state`` +
``make_train_step``, b128, bf16, augmentation inside), and pose256's
training step (``init_state`` + ``make_train_step(cfg,
loss=make_loss(cfg))``, b128, bf16: 256² augmentation through the field
warp, the VGG-16 perceptual loss with its max pools).

   1. device    torch/CUDA versions, ``nvidia-smi`` name and power limit
   2. build     the one kernel library, every ``csrc/*.cu`` built by nvcc
                (one process per source, in parallel), with ptxas's
                register counts
   3. kernel    the CUDA soft-argmax forward against its plain version:
                both variants, both align_corners, T in {1.0, 0.7}
   4. kernels   the training slice's kernels against their plain versions:
                soft-argmax backward (both variants), Gaussian raster
                forward and backward, bilinear warp (f32 and bf16, zeros and
                border, both align_corners, b128 3x128^2 and a ragged case)
   5. parity    full-width KeyNet in float32 (TF32 off) against the JAX
                keypoints committed in tests/data/torch_port_celeba128_extract.json
   6. serve     ``make_server`` (celeba128, bf16, buckets 1 8 64 256) on a free
                port, then a second one with ``--input-dtype uint8``; HTTP
                requests, concurrent ones included, checked against the same
                model with the plain soft-argmax; launch counts of the run
   7. train     full-width celeba128 in float32 (TF32 off), 3 train steps
     parity     on the warps and jitter factors JAX drew, on the card and on
                the CPU, against tests/data/torch_port_celeba128_train.json
   8. train     full-width celeba128 at b128 in bf16, 30 steps with the
                port's own draws: finite losses, float32 parameters, launch
                counts of the run
   9. times     CUDA-event medians: each kernel at the main paths' shapes
                against its plain version (and F.grid_sample for the warp),
                with its bound; extract images/s; train ms/step, frames/s
  10. profile   torch.profiler over the extract (b256, b1024, live n=1 and
                n=8) and over 5 train steps: device time against wall time,
                the ops that take the device time, each kernel's share
  11. kernels   the pose256 slice's kernels against their plain versions:
                the field warp (f32 and bf16, zeros and border, b128
                3x256^2 and ragged cases), the 2x2 max pool forward and
                backward, bit-exact (f32 and bf16, smooth and tied inputs,
                at the VGG pools' shapes); the soft-argmax and raster
                kernels, forward and backward, at N = 2,048, sigma 0.05
  12. train     full-width pose256 in float32 (TF32 off), 3 train steps on
     parity     JAX's draws and one seeded VGG file, on the card and on the
                CPU, against tests/data/torch_port_pose256_train.json
  13. train     full-width pose256 at b128 in bf16, 20 steps with the port's
                own draws: finite losses, float32 parameters, launch counts
                of the run, peak device memory
  14. times     the field warp and the pool against bound, plain and
                library; the field warp against upsample + dense warp at
                256^2 and 128^2; the bottleneck kernels at N = 2,048; the
                perceptual loss alone; train ms/step and frames/s
  15. profile   torch.profiler over 2 pose256 train steps: idle share, ops,
                each kernel's share

Run from a checkout:  python3 chip_smoke.py
The card's ``nvidia-smi`` line, then a JSON object of the kernels
(``{"kernels": [...]}``), then ``{"ok": true, "device": {...}}`` are the
last three lines of stdout. Any failed check exits non-zero before they are
printed; so does a machine without CUDA, or a copy of this file without the
rest of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from keypoints_tpu_torch.checkpoint import (load_model_state,  # noqa: E402
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config  # noqa: E402
from keypoints_tpu_torch.data.augment import (pair_from_draws,  # noqa: E402
                                              random_warp_field, warp_field)
from keypoints_tpu_torch.kernels import _build  # noqa: E402
from keypoints_tpu_torch.kernels import gaussian_cuda as gcu  # noqa: E402
from keypoints_tpu_torch.kernels import pool_cuda as pcu  # noqa: E402
from keypoints_tpu_torch.kernels import spatial_softmax_cuda as ssc  # noqa: E402
from keypoints_tpu_torch.kernels import warp_cuda as wcu  # noqa: E402
from keypoints_tpu_torch.ops.gaussian import \
    gaussian_maps as plain_gaussian  # noqa: E402
from keypoints_tpu_torch.ops.pool import max_pool_2x2 as plain_pool  # noqa: E402
from keypoints_tpu_torch.ops.spatial_softmax import \
    spatial_softmax as plain_softmax  # noqa: E402
from keypoints_tpu_torch.ops.warp import grid_sample as plain_warp  # noqa: E402
from keypoints_tpu_torch.ops.warp import upsample_field_aligned  # noqa: E402
from keypoints_tpu_torch.serve import (build_parser, http_extract,  # noqa: E402
                                       http_meta, make_live_extract,
                                       make_server)
from keypoints_tpu_torch.testing import (bf16_ulp,  # noqa: E402
                                         decode_f32, grad_norm_tolerance,
                                         random_flax_params, random_images,
                                         random_vgg_params, reference_draws,
                                         reference_warp_draws,
                                         write_torchvision_vgg)
from keypoints_tpu_torch.train import make_loss  # noqa: E402
from keypoints_tpu_torch.training import (build_model,  # noqa: E402
                                          freeze_for_inference, init_state,
                                          make_extract_fn, make_train_step,
                                          step_generator, warp_config)

KERNEL_TOL = 2e-5      # soft-argmax forward: f32 both sides, sum order only
GRAD_TOL = 1e-5        # soft-argmax backward, Gaussian maps, f32 warp
RASTER_GRAD_RTOL = 1e-4  # Gaussian backward: sums over H*W in another order
JAX_TOL = 1e-3         # docs/PARITY.md keypoint bar
TRAIN_RTOL = 1e-4      # train parity: loss and grad_norm per step
TRAIN_KP_TOL = 1e-4    # train parity: step-1 keypoints
FIELD_TOL = 3e-5       # TPS field from JAX's draws: JAX's own f32 error
SERVE_TOL = 1e-4       # same bf16 heatmaps, kernel vs plain soft-argmax
BUCKETS = (1, 8, 64, 256)
U8_BUCKETS = (1, 8)
FIELD_WARP_TOL = 1e-4  # f32 field warp: JAX's bar for its field kernel
TRAIN_BATCH = 128      # bench.py's celeba128 train step; pose256's preset
TRAIN_STEPS = 30
POSE_STEPS = 20
REFERENCE = ROOT / "tests" / "data" / "torch_port_celeba128_extract.json"
TRAIN_REFERENCE = ROOT / "tests" / "data" / "torch_port_celeba128_train.json"
POSE_REFERENCE = ROOT / "tests" / "data" / "torch_port_pose256_train.json"
META_KEYS = {"format", "version", "batches", "image_size", "channels",
             "num_keypoints", "input_dtype", "data_parallel_devices"}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM data sheet, float32 outside tensor cores

# name -> (module, counter, source, TPU kernel it replaces, launches a step
# on the (celeba128, pose256) train paths)
KERNELS = {
    "spatial_softmax_fwd": (ssc, "launches", "spatial_softmax.cu",
                            "spatial_softmax_pallas.py:151", (1, 1)),
    "spatial_softmax_bwd": (ssc, "bwd_launches", "spatial_softmax.cu",
                            "spatial_softmax_pallas.py:157", (1, 1)),
    "gaussian_fwd": (gcu, "launches", "gaussian.cu", "gaussian_pallas.py:32",
                     (1, 1)),
    "gaussian_bwd": (gcu, "bwd_launches", "gaussian.cu",
                     "gaussian_pallas.py:40", (1, 1)),
    "warp_bilinear": (wcu, "launches", "warp.cu", "warp_pallas.py:93",
                      (2, 0)),
    "warp_field": (wcu, "field_launches", "warp.cu", "warp_pallas.py:237",
                   (0, 2)),
    "max_pool_fwd": (pcu, "launches", "pool.cu", "pool_pallas.py:92",
                     (0, 4)),
    "max_pool_bwd": (pcu, "bwd_launches", "pool.cu", "pool_pallas.py:102",
                     (0, 2)),
}
PATHS = ("celeba128", "pose256")


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def reset_counts() -> None:
    for mod, counter, *_ in KERNELS.values():
        setattr(mod, counter, 0)


def read_counts() -> dict:
    return {name: getattr(mod, counter)
            for name, (mod, counter, *_) in KERNELS.items()}


class NoTF32:
    """TF32 off for cuDNN and matmul inside the block (float32 parity)."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


def cuda_median_ms(fn, runs: int = 25, reps: int = 1,
                   queue_behind_sleep: bool = True) -> float:
    """Median time of one ``fn()`` call by CUDA events, over ``runs`` runs.

    Each run times ``reps`` calls. With ``queue_behind_sleep`` the calls are
    enqueued while the GPU spins in a ~5 ms sleep, so they run back to back
    and the events see device time only; without it the events also see the
    host's launch cost, as a caller making one call at a time does.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_behind_sleep:
            torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def device_phase() -> str:
    phase("1 device")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"({torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"visible)", flush=True)
    return card


def build_phase() -> None:
    phase("2 build")
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel library {_build.library_path().name} from "
          f"{', '.join(p.name for p in _build.sources())} ready in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for line in _build.build_log.splitlines():
        if line.startswith("[") or "registers" in line or "spill" in line:
            print(line.strip(), flush=True)


def kernel_phase() -> float:
    phase("3 kernel vs plain (CUDA soft-argmax forward, f32)")
    rs = np.random.RandomState(0)
    worst = 0.0
    shapes = [(10, 32, 32), (2560, 32, 32), (10240, 32, 32), (40, 16, 16),
              (7, 13, 29)]
    for n, h, w in shapes:
        x = torch.from_numpy((3 * rs.randn(1, n, h, w)).astype(np.float32))
        x = x.cuda()
        for variant in ("marginal", "joint"):
            for align in (True, False):
                for t in (1.0, 0.7):
                    got = ssc.spatial_softmax_cuda(x, t, variant, align)
                    torch.cuda.synchronize()
                    want = plain_softmax(x, t, variant, align)
                    err = (got - want).abs().max().item()
                    worst = max(worst, err)
                    check(err <= KERNEL_TOL, f"kernel vs plain {err} > "
                          f"{KERNEL_TOL} at N={n} {h}x{w} {variant} "
                          f"align={align} T={t}")
        print(f"N={n:5d} {h}x{w}: 8 cases, max|d| so far {worst:.3e}",
              flush=True)
    # a flat heatmap centres; a sharp corner peak lands on the corner
    flat = torch.zeros((1, 1, 8, 8), device="cuda")
    peak = torch.full((1, 1, 16, 16), -30.0, device="cuda")
    peak[0, 0, 0, 15] = 30.0
    for variant in ("marginal", "joint"):
        kp_flat = ssc.spatial_softmax_cuda(flat, 1.0, variant, True)
        kp_peak = ssc.spatial_softmax_cuda(peak, 1.0, variant, True)
        torch.cuda.synchronize()
        check(kp_flat.abs().max().item() <= 1e-6, f"flat {variant} off centre")
        check((kp_peak[0, 0].cpu() - torch.tensor([1.0, -1.0])).abs().max()
              .item() <= 1e-4, f"corner peak {variant}: {kp_peak.tolist()}")
    print(f"worst max|d| {worst:.3e} (tolerance {KERNEL_TOL})", flush=True)
    return worst


def _plain_grad(fn, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x = x.detach().clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(fn(x), x, g)
    return grad


def training_kernels_phase() -> dict:
    """The kernels of the train step against their plain versions (and
    their autograd), at the main path's shapes and at ragged ones."""
    phase("4 training-slice kernels vs plain")
    rs = np.random.RandomState(1)
    errs = {}

    def record(name, err, tol, what):
        errs[name] = max(errs.get(name, 0.0), err)
        check(err <= tol, f"{name} {what}: {err} > {tol}")

    # soft-argmax backward (K1b)
    for b, k, h, w in [(128, 10, 32, 32), (1, 7, 13, 29), (2, 3, 64, 64),
                       (3, 2, 1, 5)]:
        x = torch.from_numpy((3 * rs.randn(b, k, h, w)).astype(np.float32))
        x = x.cuda()
        g = torch.from_numpy(rs.randn(b, k, 2).astype(np.float32)).cuda()
        for variant in ("marginal", "joint"):
            for align in (True, False):
                kp = ssc.spatial_softmax_cuda(x, 0.7, variant, align)
                got = ssc.spatial_softmax_bwd_cuda(x, kp, g, 0.7, variant,
                                                   align)
                torch.cuda.synchronize()
                want = _plain_grad(lambda t: plain_softmax(
                    t, 0.7, variant, align), x, g)
                record("spatial_softmax_bwd", (got - want).abs().max().item(),
                       GRAD_TOL, f"{b}x{k}x{h}x{w} {variant} align={align}")
    print(f"soft-argmax backward: 16 cases, max|d| "
          f"{errs['spatial_softmax_bwd']:.3e} (tolerance {GRAD_TOL})",
          flush=True)

    # Gaussian raster forward and backward (K2)
    for n, h, w in [(1280, 32, 32), (6, 13, 29)]:
        kp = torch.from_numpy((rs.rand(n, 2) * 2.2 - 1.1).astype(np.float32))
        kp = kp.cuda()
        g = torch.from_numpy(rs.randn(n, h, w).astype(np.float32)).cuda()
        for align in (True, False):
            maps = gcu.gaussian_fwd_cuda(kp, h, w, 0.1, align)
            dkp = gcu.gaussian_bwd_cuda(kp, g, 0.1, align)
            torch.cuda.synchronize()

            def plain(t):
                return plain_gaussian(t[None], h, w, 0.1, align)[0]
            record("gaussian_fwd", (maps - plain(kp)).abs().max().item(),
                   GRAD_TOL, f"N={n} {h}x{w} align={align}")
            want = _plain_grad(plain, kp, g)
            err = (dkp - want).abs().max().item()
            errs["gaussian_bwd"] = max(errs.get("gaussian_bwd", 0.0), err)
            scale = want.abs().max().item()
            check(err <= RASTER_GRAD_RTOL * scale,
                  f"gaussian_bwd N={n} {h}x{w} align={align}: {err} > "
                  f"{RASTER_GRAD_RTOL} x {scale}")
    print(f"Gaussian raster: forward max|d| {errs['gaussian_fwd']:.3e} "
          f"(tolerance {GRAD_TOL}), backward max|d| {errs['gaussian_bwd']:.3e}"
          f" (tolerance {RASTER_GRAD_RTOL} of the gradient's max)", flush=True)

    # bilinear warp (K4)
    for shape, out_hw in [((TRAIN_BATCH, 3, 128, 128), (128, 128)),
                          ((2, 3, 13, 29), (11, 17))]:
        img32 = torch.from_numpy(rs.rand(*shape).astype(np.float32)).cuda()
        # points outside the image included: the grid spans [-1.2, 1.2]
        grid = torch.from_numpy((rs.rand(shape[0], *out_hw, 2) * 2.4 - 1.2)
                                .astype(np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            img = img32.to(dtype)
            for padding in ("zeros", "border"):
                for align in (True, False):
                    got = wcu.warp_bilinear_cuda(img, grid, padding, align)
                    torch.cuda.synchronize()
                    want = plain_warp(img, grid, padding, align)
                    check(got.dtype == dtype, f"warp output {got.dtype}")
                    diff = (got.float() - want.float()).abs()
                    err = diff.max().item()
                    errs["warp_bilinear"] = max(errs.get("warp_bilinear", 0.0),
                                                err)
                    what = f"{shape}->{out_hw} {dtype} {padding} align={align}"
                    if dtype == torch.float32:
                        check(err <= GRAD_TOL, f"warp {what}: {err}")
                        lib = F.grid_sample(img, grid, "bilinear", padding,
                                            align)
                        check((got - lib).abs().max().item() <= GRAD_TOL,
                              f"warp vs F.grid_sample {what}")
                    else:
                        check(bool((diff <= bf16_ulp(want)).all()),
                              f"warp {what}: more than one bf16 ulp ({err})")
    print(f"warp: 16 cases, max|d| {errs['warp_bilinear']:.3e} (f32 "
          f"tolerance {GRAD_TOL}, bf16 within one bf16 ulp of plain)",
          flush=True)
    return errs


def parity_phase() -> None:
    phase("5 full-width celeba128 f32 vs committed JAX keypoints")
    ref = json.loads(REFERENCE.read_text())
    cfg = get_config(ref["preset"]).override(
        **{"train.compute_dtype": "float32"})
    with NoTF32():
        model = build_model(cfg, "cuda")
        load_model_state(model, state_dict_from_flax(
            random_flax_params(cfg, ref["param_seed"])))
        images = random_images(ref["n_images"], cfg, ref["image_seed"])
        kp = make_extract_fn(freeze_for_inference(model))(
            torch.from_numpy(images).cuda())
        kp = kp.cpu().numpy()
    want = np.asarray(ref["keypoints"], np.float32)
    check(kp.shape == want.shape, f"shape {kp.shape} != {want.shape}")
    check(bool(np.isfinite(kp).all()), "non-finite keypoints")
    err = float(np.abs(kp - want).max())
    print(f"{ref['n_images']} images, {cfg.model.num_keypoints} keypoints: "
          f"max|d| vs JAX = {err:.3e} (tolerance {JAX_TOL})", flush=True)
    check(err <= JAX_TOL, f"full-width f32 vs JAX {err} > {JAX_TOL}")


def start_server(ckpt: str, buckets, *extra: str):
    """``make_server`` on a free port, serving from a thread."""
    args = build_parser().parse_args(
        ["--preset", "celeba128", "--checkpoint", ckpt, "--port", "0",
         "--batch", *map(str, buckets), *extra])
    httpd, batcher = make_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, batcher, thread


def stop_server(httpd, batcher, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    batcher.close()
    thread.join(timeout=30)
    check(not thread.is_alive(), "server thread still running")


def serve_phase(tmp: str) -> dict:
    """The serving path: the servers' build, warm-up and every request."""
    phase(f"6 serve (celeba128, bf16, float32 server on buckets "
          f"{' '.join(map(str, BUCKETS))}, uint8 server on "
          f"{' '.join(map(str, U8_BUCKETS))})")
    cfg = get_config("celeba128")
    params = random_flax_params(cfg, 0)
    state = {k: torch.from_numpy(v) for k, v in
             state_dict_from_flax(params).items()}
    ckpt = os.path.join(tmp, "celeba128_seed0.pt")
    torch.save(state, ckpt)

    # Reference: the same bf16 model with the plain soft-argmax, on the
    # request zero-padded to a bucket. cuDNN picks its bf16 conv algorithm
    # by batch size, so a row's heatmap depends on the bucket it ran in
    # (H100: B=16 and 256 differ from B=2, 8 and 64 by up to 3.9e-3 in
    # heatmaps, 3.8e-4 in keypoints; row position and reruns are exact).
    # Each answer is held to the reference at the bucket it ran in; a
    # coalesced request may have run in any bucket from its own up to the
    # one that covers all concurrent rows, and is held to the closest.
    ref_model = build_model(cfg, "cuda")
    load_model_state(ref_model, state)
    freeze_for_inference(ref_model)
    m = cfg.model

    def reference(images: np.ndarray, bucket: int) -> np.ndarray:
        n = images.shape[0]
        x = np.zeros((bucket,) + images.shape[1:], np.float32)
        x[:n] = images
        with torch.inference_mode():
            hm = ref_model.keynet(torch.from_numpy(x).cuda()).float()
            kp = plain_softmax(hm, m.temperature, m.softmax_variant, True)
        return kp[:n].cpu().numpy()

    rs = np.random.RandomState(2)
    worst = 0.0
    latencies = []

    def verify(what: str, buckets, images: np.ndarray, got: np.ndarray,
               rows_in_flight: int | None = None) -> None:
        nonlocal worst
        n = images.shape[0]
        x = (images if images.dtype == np.float32
             else images.astype(np.float32) / 255.0)
        check(got.shape == (n, m.num_keypoints, 2),
              f"{what}: shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"{what}: non-finite")
        top = next(b for b in buckets if b >= (rows_in_flight or n))
        err, bucket = min(
            (float(np.abs(got - reference(x, b)).max()), b)
            for b in buckets if b >= n and b <= top)
        worst = max(worst, err)
        print(f"{what}: max|d| vs plain at b{bucket} = {err:.3e}",
              flush=True)
        check(err <= SERVE_TOL, f"{what}: {err} > {SERVE_TOL}")

    reset_counts()
    server = start_server(ckpt, BUCKETS)
    url = f"http://localhost:{server[0].server_address[1]}"
    min_batches = len(BUCKETS)            # warm-up runs every bucket once
    try:
        meta = http_meta(url)
        check(set(meta) == META_KEYS, f"GET / keys {sorted(meta)}")
        check(meta["batches"] == list(BUCKETS), f"buckets {meta['batches']}")

        for n in (1, 5, 64):
            images = rs.rand(n, 3, 128, 128).astype(np.float32)
            verify(f"float32 n={n}", BUCKETS, images,
                   http_extract(url, images))
            min_batches += 1
        images = rs.randint(0, 256, (3, 3, 128, 128)).astype(np.uint8)
        verify("uint8 n=3 (float32 server)", BUCKETS, images,
               http_extract(url, images))
        min_batches += 1

        requests = [rs.rand(2, 3, 128, 128).astype(np.float32)
                    for _ in range(8)]
        answers: list = [None] * len(requests)

        def client(i: int) -> None:
            answers[i] = http_extract(url, requests[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads), "concurrent requests hung")
        in_flight = sum(r.shape[0] for r in requests)
        for i, (images, got) in enumerate(zip(requests, answers)):
            check(got is not None, f"concurrent request {i} got no answer")
            verify(f"concurrent n=2 #{i}", BUCKETS, images, got, in_flight)
        min_batches += 1                  # eight requests, >= one batch

        one = rs.rand(1, 3, 128, 128).astype(np.float32)
        for _ in range(5):
            http_extract(url, one)
        for _ in range(30):
            t0 = time.perf_counter()
            http_extract(url, one)
            latencies.append(time.perf_counter() - t0)
        min_batches += 35
    finally:
        stop_server(*server)

    # --input-dtype uint8: raw frames go to the card as they are and are
    # rescaled /255 there
    server = start_server(ckpt, U8_BUCKETS, "--input-dtype", "uint8")
    url = f"http://localhost:{server[0].server_address[1]}"
    min_batches += len(U8_BUCKETS)
    try:
        meta = http_meta(url)
        check(meta["input_dtype"] == "uint8", f"input_dtype {meta}")
        for n in (1, 3):
            images = rs.randint(0, 256, (n, 3, 128, 128)).astype(np.uint8)
            verify(f"uint8 n={n} (uint8 server)", U8_BUCKETS, images,
                   http_extract(url, images))
            min_batches += 1
    finally:
        stop_server(*server)

    counts = read_counts()
    launches = counts["spatial_softmax_fwd"]
    print(f"kernel launches during serving: {counts} (device batches >= "
          f"{min_batches})", flush=True)
    check(launches >= min_batches, f"kernel launched {launches} times for "
          f">= {min_batches} device batches")
    return {"launches": launches, "serve_max_abs_err": worst,
            "http_p50_ms": float(np.median(latencies)) * 1e3}


def train_parity_phase(number: int, reference: Path, tmp: str) -> None:
    """3 full-width f32 steps on JAX's warps and factors, on the card (the
    kernels) and on this machine's CPU (the plain versions), against the
    committed JAX reference; and the port's TPS fields from JAX's draws.
    A perceptual preset's VGG weights are ``random_vgg_params`` of the
    reference's seed, in a torchvision-layout file as JAX read them."""
    ref = json.loads(reference.read_text())
    phase(f"{number} train parity: full-width {ref['preset']} f32 (TF32 "
          f"off), 3 steps on JAX's draws, card and CPU vs committed JAX "
          f"reference")
    overrides = dict(ref["overrides"])
    if "vgg_seed" in ref:
        overrides["train.vgg_ckpt"] = os.path.join(
            tmp, f"vgg16_seed{ref['vgg_seed']}.pth")
        write_torchvision_vgg(random_vgg_params(ref["vgg_seed"]),
                              overrides["train.vgg_ckpt"])
    cfg = get_config(ref["preset"]).override(**overrides)
    fields = torch.from_numpy(decode_f32(ref["fields"], ref["fields_shape"]))
    runs = {}
    with NoTF32():
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            field_err = max(
                (warp_field(d, warp_config(cfg)).cpu() - fields[i, j]).abs()
                .max().item()
                for i, step_draws in enumerate(reference_warp_draws(ref,
                                                                    device))
                for j, d in enumerate(step_draws))
            print(f"{device}: TPS fields from JAX's draws, max|d| vs JAX's "
                  f"fields {field_err:.3e} (tolerance {FIELD_TOL})",
                  flush=True)
            check(field_err <= FIELD_TOL, f"{device} TPS fields {field_err}")
            state = init_state(cfg, device)
            load_model_state(state.model, state_dict_from_flax(
                random_flax_params(cfg, ref["param_seed"])))
            images = torch.from_numpy(random_images(
                ref["batch"], cfg, ref["image_seed"])).to(device)
            draws = reference_draws(ref, device)
            src, tgt = pair_from_draws(images, draws[0], warp_config(cfg))
            with torch.no_grad():
                kp = state.model(src, tgt)[1].cpu().numpy()
            step = make_train_step(cfg, loss=make_loss(cfg, device))
            losses, norms, grads = [], [], {}
            for i, d in enumerate(draws):
                state, metrics = step(state, images, d)
                losses.append(metrics["loss"].item())
                norms.append(metrics["grad_norm"].item())
                if i == 0:
                    grads = {k: p.grad.norm().item()
                             for k, p in state.model.named_parameters()}
            check(all(p.dtype == torch.float32
                      for p in state.model.parameters()), "non-f32 params")
            runs[device] = (kp, losses, norms, grads)
            kp_err = float(np.abs(kp - np.asarray(ref["keypoints"])).max())
            loss_rel = max(abs(a / b - 1) for a, b in zip(losses,
                                                         ref["loss"]))
            norm_rel = max(abs(a / b - 1) for a, b in zip(norms,
                                                         ref["grad_norm"]))
            worst_param = max(abs(grads[k] - v) / grad_norm_tolerance(
                v, ref["grad_norm"][0]) for k, v in ref["grad_norms"].items())
            print(f"{device}: losses {losses} grad_norms {norms} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
            print(f"{device} vs JAX: step-1 keypoints max|d| {kp_err:.3e} "
                  f"(tolerance {TRAIN_KP_TOL}); loss rel {loss_rel:.3e}, "
                  f"grad_norm rel {norm_rel:.3e} (tolerance {TRAIN_RTOL}); "
                  f"per-parameter gradient norms at {worst_param:.3f} of "
                  f"their tolerance", flush=True)
            check(kp_err <= TRAIN_KP_TOL, f"{device} keypoints {kp_err}")
            check(loss_rel <= TRAIN_RTOL, f"{device} loss rel {loss_rel}")
            check(norm_rel <= TRAIN_RTOL, f"{device} grad_norm rel {norm_rel}")
            check(grads.keys() == ref["grad_norms"].keys(), "parameter names")
            check(worst_param <= 1.0, f"{device} per-parameter grad norms")
    card, cpu = runs["cuda"], runs["cpu"]
    print(f"card vs CPU: keypoints max|d| "
          f"{float(np.abs(card[0] - cpu[0]).max()):.3e}, loss rel "
          f"{max(abs(a / b - 1) for a, b in zip(card[1], cpu[1])):.3e}, "
          f"grad_norm rel "
          f"{max(abs(a / b - 1) for a, b in zip(card[2], cpu[2])):.3e}",
          flush=True)


def _train_setup(preset: str, batch: int = TRAIN_BATCH):
    """A user's train step: ``init_state`` and ``make_train_step`` with the
    preset's loss (``make_loss``: the VGG perceptual loss for pose256, with
    the seeded trunk), on a batch of seeded images."""
    cfg = get_config(preset).override(**{"train.batch_size": batch})
    state = init_state(cfg, "cuda")
    images = torch.from_numpy(random_images(batch, cfg, 4)).cuda()
    return cfg, state, make_train_step(cfg, loss=make_loss(cfg)), images


def train_phase(number: int, preset: str, steps: int):
    """The training path: ``steps`` steps, counts reset just before; every
    kernel of the path launched as often as a step launches it."""
    phase(f"{number} train ({preset} full width, b{TRAIN_BATCH}, bf16, "
          f"{steps} steps, the port's own draws)")
    cfg, state, step, images = _train_setup(preset)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, metrics = step(state, images)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    losses = torch.stack(losses).cpu().numpy()
    print(f"{steps} steps in {wall:.2f}s (first steps include cuDNN's "
          f"set-up); losses {losses[0]:.5f} -> {losses[-1]:.5f}, min "
          f"{losses.min():.5f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    print(f"kernel launches during training: {counts}", flush=True)
    check(bool(np.isfinite(losses).all()), f"non-finite losses {losses}")
    check(all(p.dtype == torch.float32 for p in state.model.parameters()),
          "parameters are not float32 after bf16 steps")
    for name, (*_, per_step) in KERNELS.items():
        want = per_step[PATHS.index(preset)] * steps
        check(counts[name] >= want,
              f"{name} launched {counts[name]} times in {steps} steps "
              f"(>= {want} expected)")
    return counts, (cfg, state, step, images)


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bottleneck_cases(b: int, k: int, sigma: float, seed: int) -> dict:
    """The soft-argmax and raster kernels at b x k heatmaps of 32^2: name ->
    (kernel call, plain call, library call or None, bound)."""
    n, hw = b * k, 32 * 32
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((3 * rs.randn(b, k, 32, 32)).astype(np.float32))
    x = x.cuda()
    kp = ssc.spatial_softmax_cuda(x)
    g_kp = torch.from_numpy(rs.randn(b, k, 2).astype(np.float32)).cuda()
    g_maps = torch.from_numpy(rs.randn(n, 32, 32).astype(np.float32)).cuda()
    kp_flat = kp.reshape(n, 2)
    x_req = x.clone().requires_grad_(True)
    kp_plain = plain_softmax(x_req)
    kp_req = kp.clone().requires_grad_(True)
    maps_plain = plain_gaussian(kp_req, 32, 32, sigma, True)
    heat_bytes = n * hw * 4
    return {
        "spatial_softmax_fwd": (
            lambda: ssc.spatial_softmax_cuda(x),
            lambda: plain_softmax(x), None,
            _bound(heat_bytes + n * 8, 3 * n * hw)),
        "spatial_softmax_bwd": (
            lambda: ssc.spatial_softmax_bwd_cuda(x, kp, g_kp),
            lambda: torch.autograd.grad(kp_plain, x_req, g_kp,
                                        retain_graph=True), None,
            _bound(2 * heat_bytes + 2 * n * 8, 4 * n * hw)),
        "gaussian_fwd": (
            lambda: gcu.gaussian_fwd_cuda(kp_flat, 32, 32, sigma),
            lambda: plain_gaussian(kp, 32, 32, sigma, True), None,
            _bound(heat_bytes + n * 8, 10 * n * hw)),
        "gaussian_bwd": (
            lambda: gcu.gaussian_bwd_cuda(kp_flat, g_maps, sigma),
            lambda: torch.autograd.grad(maps_plain, kp_req,
                                        g_maps.reshape(b, k, 32, 32),
                                        retain_graph=True), None,
            _bound(heat_bytes + 2 * n * 8, 14 * n * hw)),
    }


def _time_cases(cases: dict, card: str, reps: int = 20,
                plain_reps: int = 5, label: str = "") -> dict:
    """Kernel, plain and library device times (kernel again last) of each
    case, printed beside its bound."""
    out = {}
    for name, (kernel, plain, library, (bound_ms, bound_by)) in cases.items():
        k_ms = cuda_median_ms(kernel, reps=reps)
        p_ms = cuda_median_ms(plain, reps=plain_reps)
        l_ms = cuda_median_ms(library, reps=reps) if library else None
        k_again = cuda_median_ms(kernel, reps=reps)
        out[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        lib = f", library {l_ms * 1e3:.2f} us" if l_ms is not None else ""
        print(f"{name}{label}: kernel {k_ms * 1e3:.2f} us (again "
              f"{k_again * 1e3:.2f}), plain {p_ms * 1e3:.2f} us{lib}; bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} = "
              f"{bound_ms / k_ms:.1%} of the kernel's time  [{card}]",
              flush=True)
    return out


def kernel_times_phase(card: str, trainer) -> dict:
    """Each kernel at the train step's shapes (b128, K=10, 32^2 heatmaps,
    3x128^2 bf16 images): device time by CUDA events with the calls queued
    behind a sleep (inputs L2-warm), the plain version's time, the library
    call's where there is one, and the bound."""
    phase(f"9 times on {card}")
    cfg, *_ = trainer
    b = TRAIN_BATCH
    cases = _bottleneck_cases(b, cfg.model.num_keypoints, cfg.model.sigma, 3)
    rs = np.random.RandomState(4)
    img = torch.from_numpy(rs.rand(b, 3, 128, 128).astype(np.float32)).cuda()
    img = img.to(torch.bfloat16)
    field = random_warp_field(step_generator(0, 0, "cuda"), b,
                              warp_config(cfg))
    grid = upsample_field_aligned(field, 128, 128).contiguous()
    grid_bf16 = grid.to(torch.bfloat16)
    cases["warp_bilinear"] = (
        lambda: wcu.warp_bilinear_cuda(img, grid, "border", True),
        lambda: plain_warp(img, grid, "border", True),
        lambda: F.grid_sample(img, grid_bf16, "bilinear", "border", True),
        _bound(2 * img.nelement() * img.element_size()
               + grid.nelement() * 4, 30 * b * 128 * 128
               + 8 * img.nelement()))
    out = _time_cases(cases, card)
    print("warp library call: F.grid_sample on the bf16 image takes only a "
          "bf16 grid, so it reads the grid cast to bf16", flush=True)
    img32 = img.float()
    f32_k = cuda_median_ms(lambda: wcu.warp_bilinear_cuda(img32, grid,
                                                          "border", True),
                           reps=20)
    f32_l = cuda_median_ms(lambda: F.grid_sample(img32, grid, "bilinear",
                                                 "border", True), reps=20)
    print(f"warp f32 image, same inputs: kernel {f32_k * 1e3:.2f} us, "
          f"F.grid_sample {f32_l * 1e3:.2f} us  [{card}]", flush=True)
    return out


def softmax_and_extract_times(card: str) -> None:
    rs = np.random.RandomState(3)
    for n in (10, 2560, 10240):
        x = torch.from_numpy(rs.randn(n // 10, 10, 32, 32).astype(np.float32))
        x = x.cuda()

        def kernel():
            ssc.spatial_softmax_cuda(x, 1.0, "marginal", True)

        def plain():
            plain_softmax(x, 1.0, "marginal", True)

        kernel_ms = cuda_median_ms(kernel, reps=20)
        plain_ms = cuda_median_ms(plain, reps=20)
        kernel_call = cuda_median_ms(kernel, queue_behind_sleep=False)
        print(f"soft-argmax marginal N={n} 32x32: device time kernel "
              f"{kernel_ms * 1e3:.2f} us "
              f"({n * 32 * 32 * 4 / kernel_ms / 1e6:.0f} GB/s read), plain "
              f"{plain_ms * 1e3:.2f} us; one call with launch: kernel "
              f"{kernel_call * 1e3:.1f} us  [{card}]", flush=True)

    cfg = get_config("celeba128")
    model = build_model(cfg, "cuda")
    load_model_state(model, state_dict_from_flax(random_flax_params(cfg, 0)))
    freeze_for_inference(model)
    m = cfg.model

    def plain_path(images):
        hm = model.keynet(images).float()
        return plain_softmax(hm, m.temperature, m.softmax_variant, True)

    for b in (256, 1024):
        images = torch.from_numpy(random_images(b, cfg, 4)).cuda()
        with torch.inference_mode():
            kernel_ms = cuda_median_ms(lambda: model.extract_keypoints(images),
                                       runs=20, reps=2)
            plain_ms = cuda_median_ms(lambda: plain_path(images),
                                      runs=20, reps=2)
            kernel_again = cuda_median_ms(
                lambda: model.extract_keypoints(images), runs=20, reps=2)
        print(f"extract b{b} bf16: kernel path {b / kernel_ms * 1e3:.0f} "
              f"images/s ({kernel_ms:.3f} ms, again {kernel_again:.3f} ms), "
              f"plain path {b / plain_ms * 1e3:.0f} images/s "
              f"({plain_ms:.3f} ms)  [{card}]", flush=True)


def train_step_times(card: str, trainer, steps: int = 20) -> float:
    """ms per train step by CUDA events around ``steps`` steps (median of 3
    runs), and by the host clock to a synchronise; steps already warm."""
    cfg, state, step, images = trainer
    for _ in range(3):
        state, _ = step(state, images)
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            state, _ = step(state, images)
        end.record()
        end.synchronize()
        runs.append((start.elapsed_time(end) / steps,
                     (time.perf_counter() - t0) / steps * 1e3))
    ms = float(np.median([r[0] for r in runs]))
    print(f"{cfg.name} train step b{TRAIN_BATCH} bf16: {ms:.3f} ms/step by "
          f"CUDA events "
          f"(runs {', '.join(f'{r[0]:.3f}' for r in runs)}; host clock "
          f"{', '.join(f'{r[1]:.3f}' for r in runs)}), "
          f"{TRAIN_BATCH / ms * 1e3:.0f} frames/s  [{card}]", flush=True)
    return ms


def _profile(label: str, fn, calls: int, card: str, wall_ms: float,
             kernels: dict) -> None:
    """Device time of ``calls`` calls of ``fn`` under torch.profiler: the
    sum of the kernels and copies it saw on the card, against ``wall_ms``
    (taken without the profiler) and against the host clock around the
    profiled calls, which the profiler slows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) / calls * 1e3
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_card:
        print(f"{label}: wall {wall_ms:.3f} ms/call; device time not "
              f"measured (the profiler saw no device events)  [{card}]",
              flush=True)
        return
    device = sum(e.time_range.elapsed_us() for e in on_card) / calls / 1e3
    shares = []
    for name, keys in kernels.items():
        t = sum(e.time_range.elapsed_us() for e in on_card
                if any(key in e.name for key in keys)) / calls / 1e3
        shares.append(f"{name} {t:.4f} ms ({t / device:.2%})")
    print(f"{label}: wall {wall_ms:.3f} ms/call, device {device:.3f} "
          f"ms/call, device idle {1 - device / wall_ms:.1%} of wall; "
          f"profiled wall {profiled_ms:.3f} ms/call, idle "
          f"{1 - device / profiled_ms:.1%} of it ({calls} calls)  [{card}]",
          flush=True)
    if shares:
        print("  kernels: " + "; ".join(shares), flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=50),
          flush=True)


def profile_phase(card: str, trainer, step_ms: float) -> None:
    """Where the device time goes, by torch.profiler. Wall time is taken
    without the profiler over the same calls: by the host clock over calls
    queued back to back (extract on the card), as the median of single
    calls (live extract: each call ends in its D2H copy; the host's clock
    is noisy on a shared machine, so the median of many), or by CUDA events
    (train). Device time is the sum of the kernels and copies the profiler
    saw on the card (one stream, so they do not overlap)."""
    phase(f"10 profile on {card}")
    cfg = get_config("celeba128")
    state_dict = state_dict_from_flax(random_flax_params(cfg, 0))
    model = build_model(cfg, "cuda")
    load_model_state(model, state_dict)
    freeze_for_inference(model)
    live = make_live_extract(cfg, state_dict, (1, 8), "cuda")
    softargmax = {"soft-argmax": ("marginal_fwd", "joint_fwd")}

    def wall(fn, calls):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    def median_call(fn, calls=200):
        for _ in range(20):
            fn()
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    rs = np.random.RandomState(5)
    with torch.inference_mode():
        for b in (256, 1024):
            images = torch.from_numpy(random_images(b, cfg, 4)).cuda()
            fn = (lambda: model.extract_keypoints(images))
            _profile(f"extract b{b} bf16, images on the card", fn, 5, card,
                     wall(fn, 5), softargmax)
    for n in (1, 8):
        images = rs.rand(n, 3, 128, 128).astype(np.float32)
        fn = (lambda: live(images))
        _profile(f"live extract n={n} (H2D, Psi, soft-argmax, D2H; wall = "
                 f"median of 200 calls)", fn, 20, card, median_call(fn),
                 softargmax)

    _, state, step, images = trainer

    def train_step():
        step(state, images)

    _profile(f"train step b{TRAIN_BATCH} bf16 (wall = CUDA-event ms/step)",
             train_step, 5, card, step_ms,
             {"soft-argmax fwd": ("marginal_fwd",),
              "soft-argmax bwd": ("marginal_bwd",),
              "raster fwd": ("gaussian_fwd",),
              "raster bwd": ("gaussian_bwd",),
              "warp": ("warp_bilinear",)})


def pose_kernels_phase() -> dict:
    """The pose256 slice's kernels against their plain versions: the field
    warp at the augmentation's shape and at ragged ones, the max pool
    forward and backward at the VGG pools' shapes, bit for bit; the
    soft-argmax and raster kernels at the path's 2,048 heatmaps."""
    phase("11 pose256-slice kernels vs plain")
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {"warp_field": 0.0, "max_pool_fwd": 0.0, "max_pool_bwd": 0.0}

    def uniform(*shape, lo=-1.2, hi=1.2):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    # field warp (K5): the augmentation's fields, then fields spanning
    # [-1.2, 1.2] (points outside the image) at ragged shapes, F above and
    # below the output size
    aug_field = random_warp_field(step_generator(0, 1, "cuda"), TRAIN_BATCH,
                                  warp_config(get_config("pose256")))
    aug_field = aug_field.contiguous()
    cases = [((TRAIN_BATCH, 3, 256, 256), aug_field, (256, 256)),
             ((2, 3, 45, 61), uniform(2, 9, 9, 2), (37, 53)),
             ((3, 3, 20, 30), uniform(3, 33, 33, 2), (19, 23))]
    n_cases = 0
    for shape, field, out_hw in cases:
        img32 = torch.rand(shape, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            img = img32.to(dtype)
            for padding in ("zeros", "border"):
                for align in (True, False):
                    got = wcu.warp_field_cuda(img, field, *out_hw, padding,
                                              align)
                    torch.cuda.synchronize()
                    want = plain_warp(img, upsample_field_aligned(
                        field, *out_hw), padding, align)
                    what = (f"{shape} F={field.shape[1]} -> {out_hw} {dtype} "
                            f"{padding} align={align}")
                    check(got.dtype == dtype and got.shape == want.shape,
                          f"warp_field {what}: {got.dtype} {got.shape}")
                    diff = (got.float() - want.float()).abs()
                    errs["warp_field"] = max(errs["warp_field"],
                                             diff.max().item())
                    if dtype == torch.float32:
                        check(diff.max().item() <= FIELD_WARP_TOL,
                              f"warp_field {what}: {diff.max().item()}")
                    else:
                        check(bool((diff <= bf16_ulp(want)).all()),
                              f"warp_field {what}: more than one bf16 ulp")
                    n_cases += 1
    print(f"field warp: {n_cases} cases, max|d| {errs['warp_field']:.3e} "
          f"(f32 tolerance {FIELD_WARP_TOL}, bf16 within one bf16 ulp of "
          f"plain)", flush=True)

    # max pool (K6), forward and backward: equal to the plain version and
    # to F.max_pool2d, on smooth values and on quantised values with ReLU
    # zeros (most windows tied)
    n_cases = 0
    for shape in ((TRAIN_BATCH, 64, 256, 256), (TRAIN_BATCH, 128, 128, 128),
                  (3, 5, 6, 10)):
        pooled = (*shape[:2], shape[2] // 2, shape[3] // 2)
        for kind in ("smooth", "ties"):
            if kind == "smooth":
                x32 = torch.randn(shape, generator=gen, device="cuda")
            else:
                x32 = torch.randint(-2, 4, shape, generator=gen,
                                    device="cuda").clamp_min(0) * 0.5
            g32 = torch.randn(pooled, generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                x, g = x32.to(dtype), g32.to(dtype)
                y = pcu.max_pool_fwd_cuda(x)
                dx = pcu.max_pool_bwd_cuda(x, g)
                torch.cuda.synchronize()
                what = f"{shape} {kind} {dtype}"
                want_y = plain_pool(x)
                want_dx = _plain_grad(plain_pool, x, g)
                errs["max_pool_fwd"] = max(errs["max_pool_fwd"], (
                    y.float() - want_y.float()).abs().max().item())
                errs["max_pool_bwd"] = max(errs["max_pool_bwd"], (
                    dx.float() - want_dx.float()).abs().max().item())
                check(torch.equal(y, want_y), f"max_pool_fwd {what}")
                check(torch.equal(dx, want_dx), f"max_pool_bwd {what}")
                check(torch.equal(y, F.max_pool2d(x, 2, 2)),
                      f"max_pool_fwd vs F.max_pool2d {what}")
                check(torch.equal(dx, _plain_grad(
                    lambda t: F.max_pool2d(t, 2, 2), x, g)),
                    f"max_pool_bwd vs F.max_pool2d's gradient {what}")
                del y, dx, want_y, want_dx
                n_cases += 1
    print(f"max pool: {n_cases} cases, forward and backward equal to the "
          f"plain version and to F.max_pool2d bit for bit", flush=True)

    # the soft-argmax and raster kernels at this path's shapes: b128 x 16
    # heatmaps of 32^2, sigma 0.05, with phase 4's tolerances
    cfg = get_config("pose256").model
    cases = _bottleneck_cases(TRAIN_BATCH, cfg.num_keypoints, cfg.sigma, 5)
    for name, (kernel, plain, *_) in cases.items():
        want = plain()
        want = want[0] if isinstance(want, tuple) else want
        got = kernel().reshape(want.shape)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[name] = max(errs.get(name, 0.0), err)
        tol = {"spatial_softmax_fwd": KERNEL_TOL,
               "gaussian_bwd": RASTER_GRAD_RTOL * want.abs().max().item()
               }.get(name, GRAD_TOL)
        print(f"{name} N={TRAIN_BATCH * cfg.num_keypoints} 32x32 sigma "
              f"{cfg.sigma}: max|d| {err:.3e} (tolerance {tol:.3e})",
              flush=True)
        check(err <= tol, f"{name} at pose256's shape: {err} > {tol}")
    return errs


def pose_times_phase(card: str) -> dict:
    """The pose256 slice's kernels at b128 (3x256^2 bf16 images, the VGG
    pools in bf16, 16 keypoints): device time, plain and library times and
    the bound, as in phase 9; the field warp against upsample + dense warp
    at 256^2 and 128^2; the bottleneck kernels at N = 2,048."""
    phase(f"14 pose256 times on {card}")
    b = TRAIN_BATCH
    cfg = get_config("pose256")
    gen = torch.Generator(device="cuda").manual_seed(14)
    field = random_warp_field(step_generator(0, 2, "cuda"), b,
                              warp_config(cfg)).contiguous()
    img = torch.rand((b, 3, 256, 256), generator=gen,
                     device="cuda").to(torch.bfloat16)
    cases = {"warp_field": (
        lambda: wcu.warp_field_cuda(img, field, 256, 256, "border", True),
        lambda: plain_warp(img, upsample_field_aligned(field, 256, 256),
                           "border", True), None,
        _bound(2 * img.nelement() * 2 + field.nelement() * 4,
               50 * b * 256 * 256 + 8 * img.nelement()))}
    pool_shapes = {"pool1": (b, 64, 256, 256), "pool2": (b, 128, 128, 128)}
    pool_inputs = {}
    for label, shape in pool_shapes.items():
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16).relu()
        g = torch.randn((*shape[:2], shape[2] // 2, shape[3] // 2),
                        generator=gen, device="cuda", dtype=torch.bfloat16)
        x_req = x.clone().requires_grad_(True)
        pool_inputs[label] = (x, g, x_req, plain_pool(x_req),
                              F.max_pool2d(x_req, 2, 2))
    out = _time_cases(cases, card)
    for label, (x, g, x_req, y_plain, y_lib) in pool_inputs.items():
        nx, ny = x.nelement() * 2, x.nelement() // 2
        pool = _time_cases({
            "max_pool_fwd": (
                lambda: pcu.max_pool_fwd_cuda(x), lambda: plain_pool(x),
                lambda: F.max_pool2d(x, 2, 2),
                _bound(nx + ny, 3 * x.nelement() // 4)),
            "max_pool_bwd": (
                lambda: pcu.max_pool_bwd_cuda(x, g),
                lambda: torch.autograd.grad(y_plain, x_req, g,
                                            retain_graph=True),
                lambda: torch.autograd.grad(y_lib, x_req, g,
                                            retain_graph=True),
                _bound(2 * nx + ny, 2 * x.nelement()))},
            card, reps=10, plain_reps=3, label=f" {label} {tuple(x.shape)}")
        if label == "pool1":
            out.update(pool)
    print("pool library calls: F.max_pool2d and its autograd backward "
          "(max_pool2d_with_indices_backward); the kernels' line reports "
          "pool1, the larger call", flush=True)

    # the field kernel against the path it replaces, upsample + dense warp
    for size in (256, 128):
        im = img if size == 256 else img[:, :, :128, :128].contiguous()
        k5 = cuda_median_ms(lambda: wcu.warp_field_cuda(
            im, field, size, size, "border", True), reps=20)
        k4 = cuda_median_ms(lambda: wcu.warp_bilinear_cuda(
            im, upsample_field_aligned(field, size, size), "border", True),
            reps=20)
        k5_again = cuda_median_ms(lambda: wcu.warp_field_cuda(
            im, field, size, size, "border", True), reps=20)
        print(f"field warp b{b} 3x{size}^2 bf16: field kernel "
              f"{k5 * 1e3:.2f} us (again {k5_again * 1e3:.2f}), upsample + "
              f"dense-grid kernel {k4 * 1e3:.2f} us  [{card}]", flush=True)

    _time_cases(_bottleneck_cases(b, cfg.model.num_keypoints,
                                  cfg.model.sigma, 5), card,
                label=f" N={b * cfg.model.num_keypoints}")

    # the perceptual loss alone: the VGG trunk on a reconstruction (f32,
    # with its backward) and on a bf16 target, as the step runs it
    loss = make_loss(cfg)
    recon = torch.rand((b, 3, 256, 256), generator=gen,
                       device="cuda").requires_grad_(True)
    vgg_ms = cuda_median_ms(lambda: torch.autograd.grad(loss(recon, img),
                                                        recon), runs=5)
    print(f"perceptual loss b{b} 256^2 (VGG-16 to relu3_3 on recon and "
          f"target, bf16 convs), forward and backward: {vgg_ms:.3f} ms  "
          f"[{card}]", flush=True)
    return out


def pose_profile_phase(card: str, trainer, step_ms: float) -> None:
    phase(f"15 profile on {card}")
    _, state, step, images = trainer

    def train_step():
        step(state, images)

    _profile(f"pose256 train step b{TRAIN_BATCH} bf16 (wall = CUDA-event "
             f"ms/step)", train_step, 2, card, step_ms,
             {"soft-argmax fwd": ("marginal_fwd",),
              "soft-argmax bwd": ("marginal_bwd",),
              "raster fwd": ("gaussian_fwd",),
              "raster bwd": ("gaussian_bwd",),
              "field warp": ("warp_field",),
              "pool fwd": ("max_pool_fwd",),
              "pool bwd": ("max_pool_bwd",)})


def main() -> int:
    card = device_phase()
    build_phase()
    softmax_err = kernel_phase()
    errs = training_kernels_phase()
    errs["spatial_softmax_fwd"] = softmax_err
    parity_phase()
    with tempfile.TemporaryDirectory() as tmp:
        served = serve_phase(tmp)
        train_parity_phase(7, TRAIN_REFERENCE, tmp)
    train_counts, trainer = train_phase(8, "celeba128", TRAIN_STEPS)
    times = kernel_times_phase(card, trainer)
    softmax_and_extract_times(card)
    step_ms = train_step_times(card, trainer)
    print(f"http n=1 latency p50 {served['http_p50_ms']:.3f} ms "
          f"(30 requests, host clock)  [{card}]", flush=True)
    profile_phase(card, trainer, step_ms)
    del trainer
    torch.cuda.empty_cache()

    for name, err in pose_kernels_phase().items():
        errs[name] = max(errs.get(name, 0.0), err)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_parity_phase(12, POSE_REFERENCE, tmp)
    pose_counts, pose_trainer = train_phase(13, "pose256", POSE_STEPS)
    times.update(pose_times_phase(card))
    pose_ms = train_step_times(card, pose_trainer, steps=10)
    pose_profile_phase(card, pose_trainer, pose_ms)

    errs["spatial_softmax_fwd"] = max(errs["spatial_softmax_fwd"],
                                      served["serve_max_abs_err"])
    launches = {name: train_counts[name] + pose_counts[name]
                for name in KERNELS}
    launches["spatial_softmax_fwd"] += served["launches"]
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"keypoints_tpu_torch/csrc/{source}",
        "replaces": f"keypoints_tpu/kernels/{replaces}",
        "launches": launches[name], "max_abs_err": errs[name],
        **times[name]} for name, (_, _, source, replaces, _)
        in KERNELS.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
