"""Weights from the JAX package — port of ``keypoints_tpu/checkpoint.py:103-153``.

The port's modules carry the flax parameter paths as names
(``encoder.Conv_0.weight``, ``keynet.trunk.GroupNorm_0.weight``,
``decoder.head.bias``, ...), so a state dict written by ``keypoints-convert
export-torch`` with no ``--rename`` loads as it is:

* ``state_dict_from_flax(params)`` turns nested flax params (numpy arrays,
  or anything ``np.asarray`` takes) into that state dict — conv kernels
  HWIO → OIHW, ``kernel``/``scale`` → ``weight`` — with numpy alone;
* ``load_checkpoint(path)`` reads a ``.pt`` state dict;
* ``load_model_state(model, state_dict)`` loads ``encoder.*``, ``keynet.*``
  and ``decoder.*`` into the whole model, the autoencoder or the
  Transporter (the same three trees), with ``strict=True``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _invert_leaf(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax leaf → (torch leaf name, torch-layout array)."""
    if leaf == "kernel":
        if value.ndim == 4:                      # HWIO → OIHW
            return "weight", np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 2:                      # IO → OI
            return "weight", np.transpose(value, (1, 0))
        return "weight", value
    if leaf == "scale":                          # norm gain
        return "weight", value
    return leaf, value


def state_dict_from_flax(params: Mapping) -> dict[str, np.ndarray]:
    """Nested flax params → flat torch-layout state dict (name → ndarray).

    Keys come in sorted path order, as ``jax.tree_util`` flattens dicts;
    bf16 leaves become float32.
    """
    out: dict[str, np.ndarray] = {}

    def walk(node: Mapping, prefix: list[str]) -> None:
        for key in sorted(node):
            value = node[key]
            if isinstance(value, Mapping):
                walk(value, prefix + [str(key)])
                continue
            arr = np.asarray(value)
            if arr.dtype.name == "bfloat16":     # no torch/numpy bridge
                arr = arr.astype(np.float32)
            leaf, arr = _invert_leaf(str(key), arr)
            out[".".join(prefix + [leaf])] = arr

    walk(params, [])
    return out


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A ``torch.save``d state dict, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state(model: nn.Module, state_dict: Mapping) -> None:
    """Load a full state dict into ``model`` with ``strict=True``.

    A key the model does not have raises ``KeyError``; a key it has and the
    dict lacks raises torch's ``RuntimeError``. Values may be tensors or
    numpy arrays; each is copied into the parameter in place, in the
    parameter's dtype and on its device.
    """
    own = model.state_dict()
    trees = ", ".join(sorted({k.split(".")[0] + ".*" for k in own}))
    tensors = {}
    for key, value in state_dict.items():
        if key not in own:
            raise KeyError(f"unexpected state-dict key {key!r}: "
                           f"{type(model).__name__} has {trees}")
        tensors[key] = (value if isinstance(value, torch.Tensor)
                        else torch.from_numpy(np.array(value)))
    model.load_state_dict(tensors, strict=True)
