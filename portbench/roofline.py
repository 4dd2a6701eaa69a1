"""The least time each of the program's kernels needs for one launch at the
shapes a cell gives it: the larger of its bytes over HBM bandwidth and its
operations over the float32 peak. Each input byte is counted read once and
each output byte written once.

The byte and operation counts are those the program's kernel timings were
held to (``chip_smoke.py``'s bounds), kept here so that the yardstick does
not move with the program.
"""

from __future__ import annotations

from portbench.peaks import F32_FLOPS, HBM_BYTES_PER_S


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def softmax_fwd(n: int, h: int, w: int) -> float:
    """K1, the soft-argmax of n float32 heatmaps of h x w."""
    return bound_s(n * h * w * 4 + n * 8, 3 * n * h * w)


def softmax_bwd(n: int, h: int, w: int) -> float:
    """K1b: reads the heatmaps and the keypoints' gradient, writes the
    heatmaps' gradient."""
    return bound_s(2 * n * h * w * 4 + 2 * n * 8, 4 * n * h * w)


def gaussian_fwd(n: int, h: int, w: int) -> float:
    """K2: n keypoints rendered to float32 maps of h x w."""
    return bound_s(n * h * w * 4 + n * 8, 10 * n * h * w)


def gaussian_bwd(n: int, h: int, w: int) -> float:
    """K2's backward: reads the maps' gradient, writes the keypoints'."""
    return bound_s(n * h * w * 4 + 2 * n * 8, 14 * n * h * w)


def fused_fwd(n: int, h: int, w: int, ho: int, wo: int) -> float:
    """K3: soft-argmax of n heatmaps of h x w, then their maps of ho x wo."""
    return bound_s(n * h * w * 4 + n * ho * wo * 4 + n * 8,
                   6 * n * h * w + 10 * n * ho * wo)


def warp_field(b: int, c: int, h: int, w: int, f: int,
               elem: int = 2) -> float:
    """K5: b images of c x h x w (``elem`` bytes a value) sampled at a
    float32 field of f x f upsampled on the fly."""
    img = b * c * h * w
    return bound_s(2 * img * elem + b * f * f * 2 * 4,
                   50 * b * h * w + 8 * img)
