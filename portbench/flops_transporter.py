"""The Transporter's operations a training sample, counted from a
configuration's sizes in ``flops.py``'s convention: convolutions only, as
``torch.utils.flop_counter.FlopCounterMode`` counts them (2 x
multiply-adds; a backward pass costs one forward per input that needs a
gradient). The source frame's Phi and Psi run forward once, under the
stop-gradient; the target's Phi, Psi and the decoder forward and backward
(x3; the first conv of each net x2, its input needing no gradient). The
decoder takes the transported feature map alone, C channels, no keypoint
maps. The soft-argmax, the raster, the transport, GroupNorm and the
optimizer are left out.
"""

from __future__ import annotations

from portbench.flops import _conv, _trunk


def train_flops(spec: dict) -> int:
    """One (source, target) training pair's forward and backward pass."""
    model = spec["model"]
    size, k = model["image_size"], model["num_keypoints"]
    trunk, (c, h, w) = _trunk(model["channels"], model["encoder_filters"],
                              model["encoder_strides"], size, size)
    forward = sum(f for f, _ in trunk)
    head = _conv(c, k, 1, h, w)
    total = 2 * forward + head                       # source: Phi, Psi
    for f, needs_input_grad in trunk + trunk:        # target: Phi, Psi
        total += f * (3 if needs_input_grad else 2)
    total += 3 * head
    cin = c
    for f, up in zip(model["decoder_filters"], model["decoder_upsample"]):
        if up:
            total += 3 * 2 * cin * f * 16 * h * w    # transposed 4x4, stride 2
            h, w = 2 * h, 2 * w
        else:
            total += 3 * _conv(cin, f, 3, h, w)
        cin = f
    total += 3 * _conv(cin, model["out_channels"], 3, h, w)
    return total
