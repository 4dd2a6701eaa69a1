"""Synthetic faces — port of ``keypoints_tpu/data/faces.py``.

The celeba preset's offline stand-in: a rotated, scaled and translated
head ellipse with hair, two eyes, a nose and a mouth, rigidly attached to
the head frame, drawn with numpy (vectorized over the batch). The world
positions of the eyes, nose and mouth are the eval set's ground-truth
landmarks. :func:`render_faces` and :func:`_render_chunk` are copies of the
JAX package's numpy code, so one ``RandomState`` seed gives both packages
the same frames to the bit, and :func:`generate_face_store` writes the
same store, byte for byte, with JAX's sidecar.
"""

from __future__ import annotations

import numpy as np

from keypoints_tpu_torch.data.records import FrameStore

# (center_u, center_v, radius_u, radius_v) in the head frame; colors are
# jittered per image around these bases.
_PARTS = [
    ("hair", (0.0, -0.10, 0.54, 0.60), (0.25, 0.15, 0.08)),
    ("face", (0.0, 0.06, 0.42, 0.54), (0.85, 0.62, 0.48)),
    ("eye_l", (-0.18, -0.10, 0.075, 0.05), (0.08, 0.07, 0.10)),
    ("eye_r", (0.18, -0.10, 0.075, 0.05), (0.08, 0.07, 0.10)),
    ("nose", (0.0, 0.10, 0.045, 0.10), (0.72, 0.48, 0.36)),
    ("mouth", (0.0, 0.32, 0.15, 0.055), (0.65, 0.22, 0.20)),
]


# parts with a well-defined landmark (used as eval ground truth)
_LANDMARKS = ("eye_l", "eye_r", "nose", "mouth")


def render_faces(n: int, size: int,
                 rng: np.random.RandomState) -> tuple[np.ndarray, np.ndarray]:
    """→ (images (n,3,size,size) f32 [0,1], landmarks (n,4,2) (x,y)∈[-1,1]).

    Landmarks are the world-space centers of (eye_l, eye_r, nose, mouth) —
    the ground truth for the eval locking metric on the celeba stand-in.
    """
    return _render_chunk(n, size, rng, return_landmarks=True)


def _render_chunk(n: int, size: int, rng: np.random.RandomState,
                  return_landmarks: bool = False):
    """→ (n, 3, size, size) float32 in [0, 1] (+ optional landmarks)."""
    c = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    gx, gy = np.meshgrid(c, c, indexing="xy")             # (H, W), x = width

    cx = rng.uniform(-0.18, 0.18, n).astype(np.float32)[:, None, None]
    cy = rng.uniform(-0.15, 0.15, n).astype(np.float32)[:, None, None]
    s = rng.uniform(0.75, 1.05, n).astype(np.float32)[:, None, None]
    th = rng.uniform(-0.25, 0.25, n).astype(np.float32)[:, None, None]
    cos, sin = np.cos(th), np.sin(th)
    u = ((gx - cx) * cos + (gy - cy) * sin) / s           # (n, H, W)
    v = (-(gx - cx) * sin + (gy - cy) * cos) / s

    # background: per-image tinted vertical gradient
    bg = rng.uniform(0.25, 0.8, (n, 3, 1, 1)).astype(np.float32)
    grad = (0.85 + 0.3 * gy)[None, None]
    img = np.clip(bg * grad, 0.0, 1.0).astype(np.float32)  # (n, 3, H, W)

    edge = 3.0 / size                                     # soft ellipse edge
    marks = {}
    for name, (pu, pv, ru, rv), base in _PARTS:
        jit = rng.uniform(0.9, 1.1, (n, 1, 1)).astype(np.float32)
        q = np.sqrt(((u - pu) / (ru * jit)) ** 2
                    + ((v - pv) / (rv * jit)) ** 2)
        m = 1.0 / (1.0 + np.exp(np.clip((q - 1.0) / edge, -60.0, 60.0)))
        col = np.clip(np.asarray(base, np.float32)[None]
                      + rng.uniform(-0.08, 0.08, (n, 3)).astype(np.float32),
                      0.0, 1.0)
        img = img * (1.0 - m[:, None]) + col[:, :, None, None] * m[:, None]
        # part center back to world coords (inverse of the u,v transform)
        mx = cx + s * (pu * cos - pv * sin)
        my = cy + s * (pu * sin + pv * cos)
        marks[name] = np.concatenate([mx.reshape(n, 1), my.reshape(n, 1)], 1)
    img = np.clip(img, 0.0, 1.0)
    if return_landmarks:
        return img, np.stack([marks[k] for k in _LANDMARKS], axis=1)
    return img


def generate_face_store(out_path: str, count: int = 2048, size: int = 128,
                        seed: int = 0, chunk: int = 256) -> str:
    """Generate the synthetic face FrameStore (no pair index: the celeba
    recipe makes its pairs by warping inside the train step)."""
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(0, count, chunk):
        n = min(chunk, count - i)
        frames.append((_render_chunk(n, size, rng) * 255).astype(np.uint8))
    FrameStore.write(out_path, np.concatenate(frames),
                     meta={"origin": "synthetic_faces", "seed": seed})
    return out_path
