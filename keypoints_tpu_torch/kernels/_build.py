"""One build of every hand-written CUDA kernel of the port.

All of ``keypoints_tpu_torch/csrc/*.cu`` is compiled at first use with
``nvcc`` for ``sm_90a`` into one shared library with plain C entry points,
``_build/libkp_kernels_<hash>.so``, loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds). The hash covers every ``csrc/*.cu``
and ``*.cuh`` file and the flags, so any change of a source builds anew.
Each source is compiled to an object by its own ``nvcc`` process, all
started together, and the objects are linked once; the library is written
to a temporary name and renamed, so concurrent processes never load a
half-written file. A failed build raises with nvcc's output; nothing falls
back.

The kernel wrappers (``*_cuda.py`` beside this module) take their entry
points from :func:`entry` and keep their own launch counters.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
COMPILE_FLAGS = (*ARCH_FLAGS, "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

#: nvcc's output of the build this process loaded (ptxas register counts)
build_log = ""
#: guards the library and every wrapper's launch counter
lock = threading.Lock()

_lib: ctypes.CDLL | None = None
_entries: dict[str, ctypes._CFuncPtr] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built from source at first use")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkp_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmd: list[str], proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{out}")
    return out


def _build(path: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((src, obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        try:
            for src, _, cmd, proc in jobs:
                log.append(f"[{src.name}]\n{_run(cmd, proc)}")
        finally:
            for *_, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        part = os.path.join(tmp, path.name)
        cmd = [nvcc, *LINK_FLAGS, "-o", part, *(obj for _, obj, _, _ in jobs)]
        _run(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
        os.replace(part, path)
    return "".join(log)


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    with lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build_log = _build(path)
            _lib = ctypes.CDLL(str(path))
        return _lib


def entry(name: str, *argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the library, typed: ``int name(...)``.

    Pointers and the stream are ``ctypes.c_void_p``, so ctypes passes them
    whole (an untyped int argument would be cut to 32 bits).
    """
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def launch(fn: ctypes._CFuncPtr, on: torch.Tensor, what: str, *args) -> None:
    """Call ``fn(*args, stream)`` with ``on``'s device current and its
    current stream last; raise if the launch reports a CUDA error."""
    with torch.cuda.device(on.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def require(tensor: torch.Tensor, what: str, dtypes: tuple, ndim: int,
            memory_format: torch.memory_format = torch.contiguous_format
            ) -> None:
    """Raise unless ``tensor`` is a CUDA tensor of ``ndim`` dims, one of
    ``dtypes``, contiguous in ``memory_format``: the kernels take nothing
    else."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {tensor.device}")
    if tensor.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{what} needs {names}, got {tensor.dtype}")
    dense = tensor.is_contiguous(memory_format=memory_format)
    if tensor.ndim != ndim or not dense:
        raise ValueError(f"{what} needs a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(tensor.shape)}"
                         f"{'' if dense else ' (strided)'}")
