"""The model's operations a sample, counted from a configuration's sizes.

Convolutions only, as ``torch.utils.flop_counter.FlopCounterMode`` counts
them (2 x multiply-adds; a backward pass costs one forward per input that
needs a gradient: the weight's when it trains, the activation's when it
needs one). The nearest-x2 upsample + 3x3 conv of the decoder counts as the
stride-2 transposed 4x4 conv that equals it. The augmentation, the
soft-argmax, the raster, GroupNorm and the optimizer are left out; nothing
is counted twice for recomputation.
"""

from __future__ import annotations


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    return 2 * cin * cout * k * k * h * w


def _trunk(cin: int, filters, strides, h: int, w: int):
    """→ [(forward FLOPs, input needs a gradient?)], final (c, h, w)."""
    out = []
    for i, (f, s) in enumerate(zip(filters, strides)):
        h, w = (h - 1) // s + 1, (w - 1) // s + 1
        out.append((_conv(cin, f, 3, h, w), i > 0))
        cin = f
    return out, (cin, h, w)


def extract_flops(model: dict) -> int:
    """Psi's forward pass on one image."""
    size = model["image_size"]
    convs, (c, h, w) = _trunk(model["channels"], model["encoder_filters"],
                              model["encoder_strides"], size, size)
    return sum(f for f, _ in convs) + _conv(c, model["num_keypoints"], 1, h, w)


def train_flops(spec: dict) -> int:
    """One training sample's forward and backward pass: Phi, Psi and the
    decoder."""
    model = spec["model"]
    size, k = model["image_size"], model["num_keypoints"]
    enc, strides = model["encoder_filters"], model["encoder_strides"]
    phi, (c, h, w) = _trunk(model["channels"], enc, strides, size, size)
    total = 0
    for f, needs_input_grad in phi + phi:          # Phi, then Psi's trunk
        total += f * (3 if needs_input_grad else 2)
    total += 3 * _conv(c, k, 1, h, w)              # Psi's head
    cin = c + k
    for f, up in zip(model["decoder_filters"], model["decoder_upsample"]):
        if up:
            total += 3 * 2 * cin * f * 16 * h * w  # transposed 4x4, stride 2
            h, w = 2 * h, 2 * w
        else:
            total += 3 * _conv(cin, f, 3, h, w)
        cin = f
    total += 3 * _conv(cin, model["out_channels"], 3, h, w)
    return total
