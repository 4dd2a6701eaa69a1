"""Visualization — port of ``keypoints_tpu/viz.py``.

Keypoint overlays and image grids are numpy on the host, copies of the JAX
package's functions (``to_hwc``, ``overlay_keypoints``, ``side_by_side``,
``image_grid``). :class:`Logger` appends scalars to
``{logdir}/metrics.jsonl`` exactly as JAX does, and writes event files
through ``torch.utils.tensorboard`` where that imports (JAX writes them
through ``tensorboardX``); where it does not, it says once that the scalars
and image grids go to the jsonl only. ``video.py`` and eval's
``--overlay`` are not ported yet.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

# distinct marker colors (RGB floats), cycled over keypoints
_COLORS = np.array([
    [1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.3, 0.4, 1.0], [1.0, 1.0, 0.2],
    [1.0, 0.3, 1.0], [0.2, 1.0, 1.0], [1.0, 0.6, 0.2], [0.6, 0.2, 1.0],
    [0.6, 1.0, 0.4], [1.0, 0.4, 0.6], [0.4, 0.8, 1.0], [0.8, 0.8, 0.8],
    [0.7, 0.5, 0.2], [0.5, 0.7, 0.3], [0.3, 0.5, 0.7], [0.9, 0.9, 0.5],
], dtype=np.float32)


def to_hwc(images: np.ndarray) -> np.ndarray:
    """NCHW float images → NHWC RGB in [0,1] (grayscale broadcast to 3ch)."""
    images = np.asarray(images)
    x = np.clip(images.transpose(0, 2, 3, 1), 0.0, 1.0)
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x


def overlay_keypoints(images: np.ndarray, keypoints: np.ndarray,
                      radius: int = 2, align_corners: bool = True) -> np.ndarray:
    """Draw colored square markers at normalized (x, y) keypoints.

    images NCHW [0,1]; keypoints (B, K, 2). Returns NHWC RGB floats.
    """
    out = to_hwc(images).copy()
    b, h, w, _ = out.shape
    kp = np.asarray(keypoints)
    if align_corners:
        px = (kp[..., 0] + 1) * 0.5 * (w - 1)
        py = (kp[..., 1] + 1) * 0.5 * (h - 1)
    else:
        px = (kp[..., 0] + 1) * 0.5 * w - 0.5
        py = (kp[..., 1] + 1) * 0.5 * h - 0.5
    px = np.round(px).astype(int)
    py = np.round(py).astype(int)
    for i in range(b):
        for k in range(kp.shape[1]):
            x, y = px[i, k], py[i, k]
            if not (0 <= x < w and 0 <= y < h):
                continue
            y0, y1 = max(0, y - radius), min(h, y + radius + 1)
            x0, x1 = max(0, x - radius), min(w, x + radius + 1)
            out[i, y0:y1, x0:x1] = _COLORS[k % len(_COLORS)]
    return out


def side_by_side(*image_sets: np.ndarray) -> np.ndarray:
    """Concatenate NHWC image sets horizontally per example → (B, H, W*n, 3)."""
    return np.concatenate(image_sets, axis=2)


def image_grid(images: np.ndarray, cols: int = 4) -> np.ndarray:
    """(B, H, W, 3) → one (rows*H, cols*W, 3) grid image."""
    b, h, w, c = images.shape
    cols = min(cols, b)
    rows = (b + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), images.dtype)
    for i in range(b):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    return grid


class Logger:
    """Scalars to ``{logdir}/metrics.jsonl`` (one ``{"step": N, ...}``
    object per line, non-finite values as ``null``) and, where
    ``torch.utils.tensorboard`` imports, scalars and image grids to event
    files in ``logdir``. A no-op without a logdir."""

    def __init__(self, logdir: str | None):
        self._writer = self._jsonl = None
        if not logdir:
            return
        os.makedirs(logdir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(f"logger: no tensorboard ({e}); scalars go to "
                  f"{logdir}/metrics.jsonl only, image grids are not "
                  f"written", flush=True)
        else:
            self._writer = SummaryWriter(logdir)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a",
                           buffering=1)   # line-buffered: live tail -f

    @property
    def active(self) -> bool:
        """True when image grids are written — gate viz-only computation."""
        return self._writer is not None

    def scalars(self, step: int, **kv: float) -> None:
        if self._writer:
            for k, v in kv.items():
                self._writer.add_scalar(k, float(v), step)
        if self._jsonl:
            # non-finite floats would serialize as bare NaN/Infinity tokens,
            # which are not valid JSON
            row = {k: (float(v) if math.isfinite(float(v)) else None)
                   for k, v in kv.items()}
            self._jsonl.write(json.dumps({"step": int(step), **row}) + "\n")

    def images(self, step: int, tag: str, grid_hwc: np.ndarray) -> None:
        if self._writer:
            self._writer.add_image(tag, grid_hwc, step, dataformats="HWC")

    def close(self) -> None:
        if self._writer:
            self._writer.close()
        if self._jsonl:
            self._jsonl.close()
