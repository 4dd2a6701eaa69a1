"""Wrapper of the hand-written CUDA soft-argmax (``csrc/spatial_softmax.cu``).

Replaces the forward of ``keypoints_tpu/kernels/spatial_softmax_pallas.py``
``spatial_softmax_pallas`` (both variants) on NVIDIA Hopper. The source is
compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point, loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds). The library lives in ``keypoints_tpu_torch/_build``
under a name keyed by a hash of the sources and flags; it is written to a
temporary name and renamed, so concurrent processes never load a half-written
file. A failed build raises with nvcc's output; nothing falls back.

The plain PyTorch version of the same function is
``keypoints_tpu_torch.ops.spatial_softmax``: the tests and ``chip_smoke.py``
compare against it. Nothing on the CUDA path calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from keypoints_tpu_torch.coords import DEFAULT_ALIGN_CORNERS

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCE = _CSRC / "spatial_softmax.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
VARIANTS = {"joint": 0, "marginal": 1}
MAX_SIDE = 64          # H and W: each lane of the row's warp holds two columns

#: kernel launches so far; the wrapper adds one per launch and nowhere else
launches = 0
#: nvcc's output of the build this process loaded (ptxas register counts)
build_log = ""

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "soft-argmax kernel is built from source at first use")
    return path


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkp_spatial_softmax_{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path = _library_path()
            if not path.exists():
                build_log = _build(path)
            lib = ctypes.CDLL(str(path))
            fn = lib.kp_spatial_softmax_fwd
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def spatial_softmax_cuda(heatmaps: torch.Tensor, temperature: float = 1.0,
                         variant: str = "marginal",
                         align_corners: bool = DEFAULT_ALIGN_CORNERS
                         ) -> torch.Tensor:
    """Soft-argmax kernel: ``(B, K, H, W)`` f32 CUDA → ``(B, K, 2)`` f32, ``(x, y)``.

    Launches on the current stream of the tensor's device and does not
    synchronise. Raises on anything the kernel does not take: a tensor that
    is not a contiguous float32 CUDA tensor, H or W outside 1..64, or an
    unknown variant.
    """
    global launches
    if heatmaps.device.type != "cuda":
        raise ValueError(f"spatial_softmax_cuda needs a CUDA tensor, got "
                         f"{heatmaps.device}")
    if heatmaps.dtype != torch.float32:
        raise ValueError(f"spatial_softmax_cuda needs float32, got "
                         f"{heatmaps.dtype}")
    if heatmaps.ndim != 4 or not heatmaps.is_contiguous():
        raise ValueError(f"spatial_softmax_cuda needs a contiguous (B, K, H, "
                         f"W) tensor, got shape {tuple(heatmaps.shape)}")
    b, k, h, w = heatmaps.shape
    if not (1 <= h <= MAX_SIDE and 1 <= w <= MAX_SIDE):
        raise ValueError(f"spatial_softmax_cuda takes H, W in 1..{MAX_SIDE}, "
                         f"got {h}x{w}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown spatial softmax variant: {variant!r}")
    out = torch.empty((b, k, 2), dtype=torch.float32, device=heatmaps.device)
    n = b * k
    if n == 0:
        return out
    fn = load().kp_spatial_softmax_fwd
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(VARIANTS[variant], n, h, w, 1.0 / float(temperature),
                int(bool(align_corners)), heatmaps.data_ptr(), out.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"spatial_softmax kernel launch failed: CUDA error "
                           f"{rc} (N={n}, H={h}, W={w}, {variant})")
    with _lock:
        launches += 1
    return out
