"""The control's precision: float8 where the program computes in
bfloat16.

``Rounding(operand, grad, output)`` rounds each conv's input and weight to
``operand`` with one scale a tensor (its largest magnitude onto the format's
largest value) and takes the product in float32, as a low-precision matmul
with per-tensor scaling computes it; ``output``, when given, rounds the
conv's result the same way, as a pipeline that stores its activations in
that format; ``grad`` rounds the gradient that reaches a conv's output
before the conv's backward; :meth:`Rounding.values` rounds the training
pair, which the program makes in bfloat16. The forward roundings pass the
gradient unchanged (straight through).

:data:`FP8` is the control: e4m3 operands, activations and pair, e5m2
gradients, as fp8 training computes (the step below bfloat16 that would
tempt a later change). Of the variants read on the card (fp8 and int8,
with and without activations rounded; PERF.md §6) it is the one whose
readings stand farthest from the program's.
"""

from __future__ import annotations

import torch

#: format -> its largest finite value
TOP = {"int8": 127.0, "e4m3": 448.0, "e5m2": 57344.0}
_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def round_to(x: torch.Tensor, fmt: str) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / TOP[fmt]
    if fmt == "int8":
        return (x / scale).round().clamp(-TOP[fmt], TOP[fmt]) * scale
    return (x / scale).to(_DTYPES[fmt]).float() * scale


class _Out(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, out, grad):
        ctx.grad = grad
        return round_to(y, out) if out else y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.grad), None, None


class Rounding:
    def __init__(self, operand: str, grad: str, output: str | None = None):
        self.operand, self.grad, self.out = operand, grad, output

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A conv operand, rounded (straight-through gradient)."""
        q = round_to(x.detach(), self.operand)
        return x + (q - x).detach()

    def values(self, x: torch.Tensor) -> torch.Tensor:
        """Values that are no conv's operand (the pair), rounded."""
        return round_to(x, self.operand)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        """A conv's result: rounded when ``output`` is set, and the gradient
        that reaches it rounded to ``grad``."""
        if y.requires_grad:
            return _Out.apply(y, self.out, self.grad)
        return round_to(y, self.out) if self.out else y


#: the control
FP8 = Rounding("e4m3", "e5m2", "e4m3")
