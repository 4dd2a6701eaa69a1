"""The program's hand-written CUDA kernels, by the function names a device
trace gives them (``keypoints_tpu_torch/csrc/*.cu``). Any other kernel in a
trace is a library's (aten, cuDNN, cuBLAS)."""

from __future__ import annotations

import re

#: kernel function -> the program's name for it
KERNELS = {
    "marginal_fwd": "K1", "joint_fwd": "K1", "block_fwd": "K1",
    "marginal_bwd": "K1b", "joint_bwd": "K1b", "block_marginal_bwd": "K1b",
    "block_joint_bwd": "K1b",
    "gaussian_fwd": "K2", "gaussian_bwd": "K2 bwd",
    "fused_fwd": "K3", "block_fused_fwd": "K3",
    "warp_bilinear": "K4", "warp_field": "K5",
    "max_pool_fwd": "K6", "max_pool_bwd": "K6 bwd",
    "banded": "K7/K8",
}

_FUNC = re.compile(r"(?:^|[\s:])([A-Za-z_][A-Za-z0-9_]*)\s*(?:<|\()")


def function_of(trace_name: str) -> str | None:
    """The program's kernel function a traced kernel name is, or None."""
    for m in _FUNC.finditer(trace_name):
        if m.group(1) in KERNELS:
            return m.group(1)
    return None
