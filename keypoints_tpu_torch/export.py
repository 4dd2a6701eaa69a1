"""Bucketed serving of a batch-shaped extractor — port of ``keypoints_tpu/export.py:153-211``.

``BucketedExtract`` pads each request to the smallest covering batch bucket,
splits oversize requests into max-bucket chunks and coerces uint8/float32
inputs. Artifact export (the JAX package's ``jax.export`` bundles) waits for
the port's ``torch.export`` work.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class BucketedExtract:
    """Serve any batch size from per-bucket extract functions.

    A request of n images (a host numpy array) runs on the smallest bucket
    ≥ n: the batch is zero-padded up on the host, before the one upload
    (rows are independent through Ψ+soft-argmax, so padding never perturbs
    real outputs), and the result sliced back to n. Requests larger than the
    largest bucket are split into max-bucket chunks.
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
        images = self.coerce(images)
        n = images.shape[0]
        bucket = next((b for b in self._fns if b >= n), None)
        if bucket is None:
            return np.concatenate([self(images[i:i + self.max_batch])
                                   for i in range(0, n, self.max_batch)])
        if n < bucket:
            images = np.concatenate(
                [images, np.zeros((bucket - n,) + images.shape[1:],
                                  images.dtype)])
        return self._fns[bucket](images)[:n]
