"""The least time of the 2x2 max pool K6 (``max_pool_fwd``,
``max_pool_bwd``) at the VGG trunk's pools, as ``portbench.roofline``
bounds the other kernels: the larger of bytes over HBM bandwidth and
operations over the float32 peak, each input byte read once and each
output byte written once.
"""

from __future__ import annotations

from portbench import roofline
from portbench.reference import perceptual


def pool_fwd(n: int, c: int, h: int, w: int, elem: int = 2) -> float:
    """Reads n x c x h x w values, writes a quarter as many (3 comparisons
    an output)."""
    x = n * c * h * w
    return roofline.bound_s((x + x // 4) * elem, 3 * x // 4)


def pool_bwd(n: int, c: int, h: int, w: int, elem: int = 2) -> float:
    """Reads the input and the output's gradient, writes the input's
    gradient (3 comparisons a window again)."""
    x = n * c * h * w
    return roofline.bound_s((2 * x + x // 4) * elem, 3 * x // 4)


def shapes(spec: dict) -> list:
    """(channels, height, width) of each pool's input up to the deepest
    tap, on the configuration's images."""
    out, cin, side = [], 3, spec["model"]["image_size"]
    for _, cout, _ in perceptual.plan(spec["perceptual"]["taps"]):
        if cout:
            cin = cout
        else:
            out.append((cin, side, side))
            side //= 2
    return out


def launches(spec: dict, batch: int) -> dict:
    """Kernel function -> the least seconds of each of its launches a step:
    each pool forward on the target and on the reconstruction, backward on
    the reconstruction."""
    elem = 2 if spec["compute_dtype"] == "bfloat16" else 4
    pools = shapes(spec)
    return {"max_pool_fwd": [pool_fwd(batch, *s, elem) for s in pools] * 2,
            "max_pool_bwd": [pool_bwd(batch, *s, elem) for s in pools]}
