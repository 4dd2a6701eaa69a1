"""The perceptual loss's operations a training sample, counted from a
configuration's sizes and its ``perceptual`` section.

Convolutions only, as ``torch.utils.flop_counter.FlopCounterMode`` counts
them (2 x multiply-adds). The trunk (``portbench.reference.perceptual``,
up to its deepest tap) runs forward on the target and on the
reconstruction, and backward once to the reconstruction: one input
gradient a conv and no weight gradient, since the trunk is frozen. So a
sample costs 3 x the trunk's forward pass: 36.41 GFLOP at 128x128 to
relu5_2. The pools, the normalisation and the sum are left out.
"""

from __future__ import annotations

from portbench.reference import perceptual


def trunk_flops(taps, size: int) -> int:
    """The trunk's forward pass on one ``size`` x ``size`` image."""
    total, cin, side = 0, 3, size
    for _, cout, _ in perceptual.plan(taps):
        if cout:
            total += 2 * cin * cout * 9 * side * side
            cin = cout
        else:
            side //= 2
    return total


def loss_flops(spec: dict) -> int:
    """One training sample's share of the loss: 3 trunk passes."""
    return 3 * trunk_flops(spec["perceptual"]["taps"],
                           spec["model"]["image_size"])
