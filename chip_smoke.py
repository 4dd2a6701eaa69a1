#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Drives the celeba128 keypoint-serving path of ``keypoints_tpu_torch`` at full
width through its user entry points, with weights made from a seed:

  1. device   torch/CUDA versions, ``nvidia-smi`` name and power limit
  2. build    the soft-argmax kernel library, built from ``csrc/`` with nvcc
  3. kernel   the CUDA soft-argmax against its plain PyTorch version on the
              card: both variants, both align_corners, T in {1.0, 0.7}
  4. parity   full-width KeyNet in float32 (TF32 off) against the JAX
              keypoints committed in tests/data/torch_port_celeba128_extract.json
  5. serve    ``make_server`` (celeba128, bf16, buckets 1 8 64 256) on a free
              port, then a second one with ``--input-dtype uint8``; HTTP
              requests, concurrent ones included, checked against the same
              model with the plain soft-argmax; the kernel's launch count
              over the whole serving run
  6. times    CUDA-event medians: soft-argmax kernel vs plain, extract
              images/s kernel path vs plain path, p50 latency of an n=1 request
  7. profile  torch.profiler over the extract at b256 and b1024 and over live
              n=1 and n=8 requests: device time against wall time, and the
              ops that take the device time

Run from a checkout:  python3 chip_smoke.py
The last two lines of stdout are a JSON object of the kernels
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero before either is printed; so does a machine without
CUDA, or a copy of this file without the rest of the repository.
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

from keypoints_tpu_torch.checkpoint import (load_model_state,  # noqa: E402
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config  # noqa: E402
from keypoints_tpu_torch.kernels import spatial_softmax_cuda as ssc  # noqa: E402
from keypoints_tpu_torch.ops.spatial_softmax import \
    spatial_softmax as plain_softmax  # noqa: E402
from keypoints_tpu_torch.serve import (build_parser, http_extract,  # noqa: E402
                                       http_meta, make_live_extract,
                                       make_server)
from keypoints_tpu_torch.testing import (random_flax_params,  # noqa: E402
                                         random_images)
from keypoints_tpu_torch.training import build_model, make_extract_fn  # noqa: E402

KERNEL_TOL = 2e-5      # f32 on both sides; only the order of the sums differs
JAX_TOL = 1e-3         # docs/PARITY.md keypoint bar
SERVE_TOL = 1e-4       # same bf16 heatmaps, kernel vs plain soft-argmax
BUCKETS = (1, 8, 64, 256)
U8_BUCKETS = (1, 8)
REFERENCE = ROOT / "tests" / "data" / "torch_port_celeba128_extract.json"
META_KEYS = {"format", "version", "batches", "image_size", "channels",
             "num_keypoints", "input_dtype", "data_parallel_devices"}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


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
    print(f"card: {card}  ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)", flush=True)
    return card


def build_phase() -> None:
    phase("2 build")
    t0 = time.perf_counter()
    ssc.load()
    print(f"kernel library ready in {time.perf_counter() - t0:.2f}s",
          flush=True)
    if ssc.build_log.strip():
        print(ssc.build_log.strip(), flush=True)


def kernel_phase() -> float:
    phase("3 kernel vs plain (CUDA soft-argmax, f32)")
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
                    print(f"N={n:5d} {h}x{w} {variant:8s} align={align!s:5s}"
                          f" T={t}: max|d|={err:.3e}", flush=True)
                    check(err <= KERNEL_TOL, f"kernel vs plain {err} > "
                          f"{KERNEL_TOL} at N={n} {h}x{w} {variant} "
                          f"align={align} T={t}")
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


def parity_phase() -> None:
    phase("4 full-width celeba128 f32 vs committed JAX keypoints")
    ref = json.loads(REFERENCE.read_text())
    cfg = get_config(ref["preset"]).override(
        **{"train.compute_dtype": "float32"})
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = build_model(cfg, "cuda")
        load_model_state(model, state_dict_from_flax(
            random_flax_params(cfg, ref["param_seed"])))
        images = random_images(ref["n_images"], cfg, ref["image_seed"])
        kp = make_extract_fn(model)(torch.from_numpy(images).cuda())
        kp = kp.cpu().numpy()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
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
    """The main path: the servers' build, warm-up and every request."""
    phase(f"5 serve (celeba128, bf16, float32 server on buckets "
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

    ssc.launches = 0
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

    launches = ssc.launches
    print(f"soft-argmax kernel launches during serving: {launches} "
          f"(device batches >= {min_batches})", flush=True)
    check(launches >= min_batches, f"kernel launched {launches} times for "
          f">= {min_batches} device batches")
    return {"launches": launches, "serve_max_abs_err": worst,
            "http_p50_ms": float(np.median(latencies)) * 1e3}


def times_phase(card: str) -> dict:
    phase(f"6 times on {card}")
    out = {}
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
        kernel_again = cuda_median_ms(kernel, reps=20)
        kernel_call = cuda_median_ms(kernel, queue_behind_sleep=False)
        plain_call = cuda_median_ms(plain, queue_behind_sleep=False)
        out[n] = (kernel_ms, plain_ms)
        print(f"soft-argmax marginal N={n} 32x32: device time kernel "
              f"{kernel_ms * 1e3:.2f} us (again {kernel_again * 1e3:.2f}, "
              f"{n * 32 * 32 * 4 / kernel_ms / 1e6:.0f} GB/s read), plain "
              f"{plain_ms * 1e3:.2f} us; one call with launch: kernel "
              f"{kernel_call * 1e3:.1f} us, plain {plain_call * 1e3:.1f} us"
              f"  [{card}]", flush=True)

    cfg = get_config("celeba128")
    model = build_model(cfg, "cuda")
    load_model_state(model, state_dict_from_flax(random_flax_params(cfg, 0)))
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
    return out


def profile_phase(card: str) -> None:
    """Where the device time of an extract goes, by torch.profiler.

    Wall time is taken by the host clock over the same calls without the
    profiler; device time is the sum of the kernels and copies the profiler
    saw on the card (one stream, so they do not overlap).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    phase(f"7 profile on {card}")
    cfg = get_config("celeba128")
    state = state_dict_from_flax(random_flax_params(cfg, 0))
    model = build_model(cfg, "cuda")
    load_model_state(model, state)
    live = make_live_extract(cfg, state, (1, 8), "cuda")

    def run(label: str, fn, calls: int) -> None:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if not on_card:
            print(f"{label}: wall {wall:.3f} ms/call; device time not "
                  f"measured (the profiler saw no device events)  [{card}]",
                  flush=True)
            return
        device = sum(e.time_range.elapsed_us() for e in on_card) / calls / 1e3
        softargmax = sum(e.time_range.elapsed_us() for e in on_card
                         if "marginal_fwd" in e.name or "joint_fwd" in e.name)
        softargmax /= calls * 1e3
        print(f"{label}: wall {wall:.3f} ms/call, device {device:.3f} ms/call,"
              f" device idle {1 - device / wall:.1%} of wall, soft-argmax "
              f"kernel {softargmax:.4f} ms/call ({calls} calls)  [{card}]",
              flush=True)
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=12,
                                        max_name_column_width=50), flush=True)

    rs = np.random.RandomState(5)
    with torch.inference_mode():
        for b in (256, 1024):
            images = torch.from_numpy(random_images(b, cfg, 4)).cuda()
            run(f"extract b{b} bf16, images on the card",
                lambda: model.extract_keypoints(images), 5)
    for n in (1, 8):
        images = rs.rand(n, 3, 128, 128).astype(np.float32)
        run(f"live extract n={n} (H2D, Psi, soft-argmax, D2H)",
            lambda: live(images), 20)


def main() -> int:
    card = device_phase()
    build_phase()
    worst = kernel_phase()
    parity_phase()
    with tempfile.TemporaryDirectory() as tmp:
        served = serve_phase(tmp)
    softmax_times = times_phase(card)
    print(f"http n=1 latency p50 {served['http_p50_ms']:.3f} ms "
          f"(30 requests, host clock)  [{card}]", flush=True)
    profile_phase(card)
    kernel_ms, plain_ms = softmax_times[2560]
    print(json.dumps({"kernels": [{
        "name": "spatial_softmax_fwd", "route": "cuda",
        "source": "keypoints_tpu_torch/csrc/spatial_softmax.cu",
        "replaces": "keypoints_tpu/kernels/spatial_softmax_pallas.py:267",
        "launches": served["launches"],
        "max_abs_err": max(worst, served["serve_max_abs_err"]),
        "ms": kernel_ms, "plain_ms": plain_ms}]}), flush=True)
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
