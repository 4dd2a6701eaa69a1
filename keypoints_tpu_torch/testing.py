"""Seeded inputs shared by the tests and ``chip_smoke.py``.

Parameters and images come from ``np.random.RandomState`` (its stream is
stable across numpy versions), so the same seed gives the same arrays to the
JAX package and to the port, here and on the GPU machine. The committed JAX
reference ``tests/data/torch_port_celeba128_extract.json`` is made from
``random_flax_params(celeba128, 0)`` and ``random_images(4, celeba128, 1)``.
"""

from __future__ import annotations

import numpy as np

from keypoints_tpu_torch.configs import Config


def random_flax_params(cfg: Config, seed: int = 0) -> dict:
    """KeyNet params of ``cfg`` in flax layout (HWIO kernels), as numpy float32.

    → ``{"keynet": {"trunk": {"Conv_i": ..., "GroupNorm_i": ...}, "head": ...}}``,
    the subtree the extract path reads. Kernels have variance 1/fan_in;
    biases and GroupNorm affines are perturbed so every parameter matters.
    """
    rs = np.random.RandomState(seed)

    def draw(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rs.randn(*shape)).astype(np.float32)

    m = cfg.model
    trunk, cin = {}, cfg.data.channels
    for i, f in enumerate(m.encoder_filters):
        trunk[f"Conv_{i}"] = {"kernel": draw(3, 3, cin, f,
                                             scale=1 / np.sqrt(9 * cin)),
                              "bias": draw(f, scale=0.1)}
        trunk[f"GroupNorm_{i}"] = {"scale": draw(f, scale=0.1, offset=1.0),
                                   "bias": draw(f, scale=0.1)}
        cin = f
    head = {"kernel": draw(1, 1, cin, m.num_keypoints,
                           scale=0.3 / np.sqrt(cin)),
            "bias": draw(m.num_keypoints, scale=0.1)}
    return {"keynet": {"trunk": trunk, "head": head}}


def random_images(n: int, cfg: Config, seed: int = 1) -> np.ndarray:
    """(n, C, S, S) float32 images in [0, 1)."""
    d = cfg.data
    return np.random.RandomState(seed).rand(
        n, d.channels, d.image_size, d.image_size).astype(np.float32)
