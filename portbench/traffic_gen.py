"""Inputs that clients send, drawn from the seed with numpy alone."""

from __future__ import annotations

import numpy as np

HOST_SALT = 19


def host_frames(seed: int, n: int, shape) -> np.ndarray:
    """``n`` uint8 frames of ``shape`` (C, H, W)."""
    rng = np.random.default_rng([int(seed), HOST_SALT])
    return rng.integers(0, 256, (n, *shape), dtype=np.uint8)
